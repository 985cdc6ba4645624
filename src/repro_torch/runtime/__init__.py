from repro_torch.runtime.trainer import Trainer, TrainState
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["Trainer", "TrainState", "StragglerMonitor"]
