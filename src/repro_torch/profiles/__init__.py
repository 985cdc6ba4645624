"""Machine profiles: device fingerprints, fitted models, presets, the
measurement cache and the calibration CLI."""
from repro_torch.profiles.cache import (
    CACHE_SCHEMA_VERSION,
    CacheEntry,
    GCStats,
    MeasurementCache,
)
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    PROFILE_SCHEMA_VERSION,
    MachineProfile,
    ModelFit,
    ProfileError,
    TunedChoice,
    load_profile,
    merge_profiles,
    save_profile,
)

__all__ = ["CACHE_SCHEMA_VERSION", "CacheEntry", "DeviceFingerprint",
           "GCStats", "MachineProfile", "MeasurementCache", "ModelFit",
           "PROFILE_SCHEMA_VERSION", "ProfileError", "TunedChoice",
           "load_profile", "merge_profiles", "save_profile"]
