"""``repro_torch.api`` — the prediction facade: :class:`PerfSession`
(open a profile, predict any kernel, explained), :class:`PredictEngine`
(the pure math underneath), :class:`Prediction` and
:class:`PredictionError`."""
from repro_torch.api.engine import DEFAULT_MODEL, PredictEngine
from repro_torch.api.errors import PredictionError, suggest_calibration_tags
from repro_torch.api.prediction import Prediction
from repro_torch.api.session import PerfSession

__all__ = [
    "DEFAULT_MODEL",
    "PerfSession",
    "PredictEngine",
    "Prediction",
    "PredictionError",
    "suggest_calibration_tags",
]
