"""``python -m repro_torch.calibrate`` — machine-calibration entry point
(see :mod:`repro_torch.profiles.cli`, or ``--help``)."""
import sys

from repro_torch.profiles.cli import main

if __name__ == "__main__":
    sys.exit(main())
