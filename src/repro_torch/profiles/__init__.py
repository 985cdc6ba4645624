"""Machine profiles: device fingerprints, fitted models, presets and the
calibration CLI."""
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    MachineProfile,
    ModelFit,
    ProfileError,
    load_profile,
    save_profile,
)

__all__ = ["DeviceFingerprint", "MachineProfile", "ModelFit",
           "ProfileError", "load_profile", "save_profile"]
