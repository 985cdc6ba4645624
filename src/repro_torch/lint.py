"""``python -m repro_torch.lint`` — static modelability audit entry point.

Thin shim over :mod:`repro_torch.analysis.cli`; see that module (or
``--help``) for the flag reference.  Lints kernels, count families, and
model zoos without executing or timing a single kernel.
"""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
