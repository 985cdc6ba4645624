"""``python -m repro_torch.serve`` — alias for the serving-daemon CLI
(:mod:`repro_torch.serving.cli`)."""
import sys

from repro_torch.serving.cli import main

if __name__ == "__main__":
    sys.exit(main())
