"""Machine profiles: device fingerprints, fitted models, presets, the
measurement cache and the calibration CLI."""
from repro_torch.profiles.cache import CacheEntry, GCStats, MeasurementCache
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    MachineProfile,
    ModelFit,
    ProfileError,
    TunedChoice,
    load_profile,
    merge_profiles,
    save_profile,
)

__all__ = ["CacheEntry", "DeviceFingerprint", "GCStats", "MachineProfile",
           "MeasurementCache", "ModelFit", "ProfileError", "load_profile",
           "TunedChoice", "merge_profiles", "save_profile"]
