"""Cross-machine study subsystem: the model zoo, one-battery multi-fit,
profile compare and the scope-vs-accuracy sweep.

* :data:`MODEL_ZOO` / :class:`ZooEntry` — named model forms at
  increasing scope (linear flop-only → flop+membw → nonlinear overlap)
* :func:`run_study` — gather one battery, fit the whole zoo, keep fits +
  held-out rows in a :class:`~repro_torch.profiles.MachineProfile`
* :func:`compare_profiles` / :class:`StudyReport` — per-model ×
  per-variant held-out relative-error tables (JSON + markdown)
* :func:`merge_any` / fleet bundles — collect profiles across machines
"""
from repro_torch.studies.study import (
    FLEET_SCHEMA_VERSION,
    StudyError,
    StudyReport,
    compare_profiles,
    fleet_to_dict,
    load_profiles_any,
    merge_any,
    profile_accuracy,
    run_study,
    scope_accuracy_sweep,
    sweep_to_markdown,
)
from repro_torch.studies.zoo import (
    LIN_FLOP,
    LIN_FLOP_MEM,
    MODEL_ZOO,
    OVL_FLOP_MEM,
    STUDY_SMOKE_TAGS,
    STUDY_TAGS,
    ZooEntry,
    zoo_entry,
    zoo_models,
)

__all__ = [
    "FLEET_SCHEMA_VERSION",
    "LIN_FLOP",
    "LIN_FLOP_MEM",
    "MODEL_ZOO",
    "OVL_FLOP_MEM",
    "STUDY_SMOKE_TAGS",
    "STUDY_TAGS",
    "StudyError",
    "StudyReport",
    "ZooEntry",
    "compare_profiles",
    "fleet_to_dict",
    "load_profiles_any",
    "merge_any",
    "profile_accuracy",
    "run_study",
    "scope_accuracy_sweep",
    "sweep_to_markdown",
    "zoo_entry",
    "zoo_models",
]
