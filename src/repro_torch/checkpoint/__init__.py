from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_tree,
    save_tree,
)
from repro_torch.profiles.profile import atomic_write_json

__all__ = ["CheckpointManager", "atomic_write_json", "restore_tree",
           "save_tree"]
