"""``PerfSession`` — one object from kernel → counts → prediction; the
counterpart of ``repro.api.session``::

    from repro_torch.api import PerfSession
    from repro_torch.analysis.targets import f32
    from repro_torch.kernels import ops

    session = PerfSession.open("machine_profile.json")
    pred = session.predict(ops.matmul, f32(4096, 4096), f32(4096, 4096))
    print(pred.seconds, pred.explain(top=3))

Opening from a profile performs no measurement, and prediction never
times a kernel: counts come from :func:`repro_torch.core.counting.count_fn`
(fake tensors, nothing executes) and every batch is one evaluation.
``session.timer.calls`` is the observable of that guarantee.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.api.engine import DEFAULT_MODEL, PredictEngine
from repro_torch.api.prediction import Prediction
from repro_torch.core.counting import FeatureCounts, count_fn
from repro_torch.core.uipick import (
    CountingTimer,
    MeasurementKernel,
    default_timer,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    MachineProfile,
    load_profile,
    save_profile,
)

__all__ = ["DEFAULT_MODEL", "PerfSession", "PredictItem"]

# one predict_batch item: a measurement kernel, a bare callable, or a
# (callable, example_args) pair
PredictItem = Union[MeasurementKernel, Callable, Tuple[Callable, tuple]]


class PerfSession:
    """A loaded machine profile plus the prediction engine over it."""

    def __init__(self, profile: MachineProfile, *,
                 timer: Optional[CountingTimer] = None):
        self.profile = profile
        # the timing seam; prediction must leave .calls where opening
        # left it
        self.timer = timer if timer is not None else CountingTimer()
        self.predict_engine = PredictEngine(profile)

    @property
    def eval_calls(self) -> int:
        return self.predict_engine.eval_calls

    @classmethod
    def open(cls, source: Union[None, str, Path, MachineProfile, Any] = None,
             *, tags: Optional[Sequence[str]] = None, trials: int = 8,
             holdout_fraction: float = 0.25,
             timer: Optional[Callable] = None,
             device: DeviceLike = "cuda",
             save_to: Union[None, str, Path] = None) -> "PerfSession":
        """Open a prediction session.  ``source`` selects where the fitted
        models come from:

        * a **path** or a :class:`MachineProfile` — zero measurements;
        * ``None`` — calibrate THIS machine on demand: the model-zoo study
          (:func:`repro_torch.studies.run_study`: gather ``tags``, default
          ``STUDY_TAGS``, fit the zoo, keep a holdout) timed on
          ``device``, or through ``timer(kernel, trials)`` when one is
          given (the fingerprint is then still ``device``'s);
        * a **device object** with ``.fingerprint`` and ``.timer`` (a
          :class:`~repro_torch.testing.synthdev.SyntheticDevice`) —
          calibrate that device through its timer.

        ``save_to`` keeps an on-demand calibration as a profile file.
        The session's ``timer`` is the calibration's: its ``calls`` count
        the study's timings, and prediction adds none."""
        if isinstance(source, MachineProfile):
            return cls(source)
        if isinstance(source, (str, Path)):
            return cls(load_profile(source))
        from repro_torch.studies.study import run_study
        from repro_torch.studies.zoo import STUDY_TAGS

        if source is None:
            fingerprint = DeviceFingerprint.local(device)
            base = timer or functools.partial(default_timer,
                                              device=resolve_device(device))
        elif hasattr(source, "fingerprint") and hasattr(source, "timer"):
            fingerprint = source.fingerprint
            base = timer or source.timer
        else:
            raise TypeError(
                f"PerfSession.open expects a profile path, a "
                f"MachineProfile, a device with .fingerprint/.timer, or "
                f"None (this machine); got {type(source).__name__}")
        counting = CountingTimer(base)
        profile = run_study(fingerprint=fingerprint, timer=counting,
                            tags=tags or STUDY_TAGS, trials=trials,
                            holdout_fraction=holdout_fraction)
        if save_to is not None:
            save_profile(profile, save_to)
        return cls(profile, timer=counting)

    def predict(self, fn: PredictItem, *args,
                model: Optional[str] = None, name: Optional[str] = None,
                strict: bool = False) -> Prediction:
        """Predict one kernel: a callable with example arguments (any
        device, ``meta`` included) or a :class:`MeasurementKernel`."""
        item = fn if isinstance(fn, MeasurementKernel) else (fn, args)
        return self.predict_batch(
            [item], model=model,
            names=[name] if name is not None else None, strict=strict)[0]

    def predict_batch(self, items: Sequence[PredictItem], *,
                      model: Optional[str] = None,
                      names: Optional[Sequence[str]] = None,
                      strict: bool = False) -> List[Prediction]:
        """Predict every item in one batched evaluation; zero timings."""
        items = list(items)
        if not items:
            return []
        if names is not None and len(names) != len(items):
            raise ValueError(f"names has {len(names)} entries for "
                             f"{len(items)} items")
        self.predict_engine.resolve(model)      # fail fast, pre-counting
        kernel_names: List[str] = []
        rows: List[FeatureCounts] = []
        for idx, item in enumerate(items):
            kname, counts = _count_item(item, idx)
            kernel_names.append(names[idx] if names is not None else kname)
            rows.append(counts)
        return self.predict_engine.predict_rows(
            rows, kernel_names, model=model, strict=strict)


def _count_item(item: PredictItem, idx: int) -> Tuple[str, FeatureCounts]:
    if isinstance(item, MeasurementKernel):
        return item.name, item.counts()
    if isinstance(item, tuple):
        fn, args = item
    elif callable(item):
        fn, args = item, ()
    else:
        raise TypeError(
            f"predict item #{idx} must be a MeasurementKernel, a "
            f"callable, or a (callable, args) pair; "
            f"got {type(item).__name__}")
    kname = getattr(fn, "__name__", None) or getattr(
        getattr(fn, "func", None), "__name__", "kernel")
    return f"{kname}[{idx}]", count_fn(fn, *args)
