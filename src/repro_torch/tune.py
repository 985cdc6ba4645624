"""``python -m repro_torch.tune`` — predictor-guided autotuning entry
point.

Thin shim over :mod:`repro_torch.tuning.cli`; see that module (or
``--help``) for the flag reference.  The search library itself is
:mod:`repro_torch.tuning`.
"""
import sys

from repro_torch.tuning.cli import main

if __name__ == "__main__":
    sys.exit(main())
