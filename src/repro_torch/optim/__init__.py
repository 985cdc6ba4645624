from repro_torch.optim.adamw import (
    OptState,
    abstract_opt_state,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_schedule,
)

__all__ = [
    "OptState",
    "abstract_opt_state",
    "apply_updates",
    "global_norm",
    "init_opt_state",
    "lr_schedule",
]
