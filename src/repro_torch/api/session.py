"""``PerfSession`` — one object from kernel → counts → prediction; the
counterpart of ``repro.api.session``::

    from repro_torch.api import PerfSession
    from repro_torch.analysis.targets import f32
    from repro_torch.kernels import ops

    session = PerfSession.open("machine_profile.json")
    pred = session.predict(ops.matmul, f32(4096, 4096), f32(4096, 4096))
    print(pred.seconds, pred.explain(top=3))

Opening from a profile performs no measurement, and prediction never
times a kernel: counts come from the count engine
(:class:`~repro_torch.core.countengine.CountEngine`: fake tensors,
nothing executes; memoized by content and persisted beside a measurement
cache when the session has one) and every batch is one evaluation.
``session.timer.calls`` and ``session.engine.trace_count`` are the
observables of those guarantees.

Prediction is thread-safe: the predict engine and the count engine
serialize internally, so one session is shared across every request
thread of a serving daemon.  Opening and calibrating follow a
single-writer convention.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.api.engine import DEFAULT_MODEL, PredictEngine
from repro_torch.api.errors import PredictionError
from repro_torch.api.prediction import Prediction
from repro_torch.core.countengine import (
    CountEngine,
    args_signature,
    callable_signature,
)
from repro_torch.core.counting import FeatureCounts
from repro_torch.core.uipick import (
    CountingTimer,
    MeasurementKernel,
    default_timer,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.profiles.cache import MeasurementCache
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    MachineProfile,
    ProfileError,
    load_profile,
    save_profile,
)

__all__ = ["DEFAULT_MODEL", "PerfSession", "PredictItem"]

# one predict_batch item: a measurement kernel, a bare callable, or a
# (callable, example_args) pair
PredictItem = Union[MeasurementKernel, Callable, Tuple[Callable, tuple]]


class PerfSession:
    """A loaded machine profile plus the resources to predict with it:
    the pure :class:`PredictEngine`, the measurement cache, the count
    engine and the timer seam (used only if calibration runs)."""

    def __init__(self, profile: MachineProfile, *,
                 cache: Optional[MeasurementCache] = None,
                 timer: Optional[CountingTimer] = None,
                 engine: Optional[CountEngine] = None,
                 calibration: Optional[Dict[str, Any]] = None):
        self.profile = profile
        self.cache = cache
        # the timing seam; prediction must leave .calls where opening
        # left it
        self.timer = _as_counting_timer(timer)
        # in-process memo plus a persistent tier beside the measurement
        # cache, when one is attached
        self.engine = engine if engine is not None else CountEngine(
            store=cache.count_store if cache is not None else None)
        # how the profile came to be: timings, cache hits, count traces
        # and re-timed rows of an on-demand calibration
        self.calibration: Dict[str, Any] = dict(calibration or {})
        self.predict_engine = PredictEngine(profile)

    @property
    def eval_calls(self) -> int:
        return self.predict_engine.eval_calls

    @property
    def trace_count(self) -> int:
        """Batched evaluators built, one per distinct model signature."""
        return self.predict_engine.trace_count

    @classmethod
    def open(cls, source: Union[None, str, Path, MachineProfile, Any] = None,
             *, tags: Optional[Sequence[str]] = None, trials: int = 8,
             cache: Union[None, str, Path, MeasurementCache] = None,
             expected_fingerprint: Union[None, str,
                                         DeviceFingerprint] = None,
             holdout_fraction: float = 0.25,
             retime_rel_std: Optional[float] = None,
             timer: Optional[Callable] = None,
             engine: Optional[CountEngine] = None,
             device: DeviceLike = "cuda",
             save_to: Union[None, str, Path] = None) -> "PerfSession":
        """Open a prediction session.  ``source`` selects where the fitted
        models come from:

        * a **path** or a :class:`MachineProfile` — zero measurements
          (``timer``, when given, is what a later confirmation timing
          such as :func:`repro_torch.tuning.tune_space` runs through);
          with ``expected_fingerprint`` (a fingerprint, or ``"local"``
          for ``device``'s) a profile of another machine raises
          :class:`~repro_torch.profiles.ProfileError`;
        * ``None`` — calibrate THIS machine on demand: the model-zoo study
          (:func:`repro_torch.studies.run_study`: gather ``tags``, default
          ``STUDY_TAGS``, fit the zoo, keep a holdout) timed on
          ``device``, or through ``timer(kernel, trials)`` when one is
          given (the fingerprint is then still ``device``'s);
        * a **device object** with ``.fingerprint`` and ``.timer`` (a
          :class:`~repro_torch.testing.synthdev.SyntheticDevice`) —
          calibrate that device through its timer.

        ``cache`` (a :class:`MeasurementCache` or a directory) serves the
        calibration's timings and the prediction's counts;
        ``retime_rel_std`` is forwarded to the gather; ``save_to`` keeps
        an on-demand calibration as a profile file.  The session's
        ``timer`` is the calibration's: its ``calls`` count the study's
        timings, and prediction adds none."""
        if expected_fingerprint == "local":
            expected_fingerprint = DeviceFingerprint.local(device)
        if isinstance(source, (str, Path)):
            profile = load_profile(source,
                                   expected_fingerprint=expected_fingerprint)
            return cls(profile, cache=_as_cache(cache, profile.fingerprint),
                       timer=timer, engine=engine,
                       calibration={"source": f"profile:{source}",
                                    "timings": 0, "retimed": 0})
        if isinstance(source, MachineProfile):
            _check_fingerprint(source, expected_fingerprint)
            return cls(source, cache=_as_cache(cache, source.fingerprint),
                       timer=timer, engine=engine,
                       calibration={"source": "profile", "timings": 0,
                                    "retimed": 0})
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
        counting = _as_counting_timer(base)
        mcache = _as_cache(cache, fingerprint)
        if engine is None:
            engine = CountEngine(
                store=mcache.count_store if mcache is not None else None)
        profile = run_study(fingerprint=fingerprint, timer=counting,
                            cache=mcache, tags=tags or STUDY_TAGS,
                            trials=trials,
                            holdout_fraction=holdout_fraction,
                            retime_rel_std=retime_rel_std, engine=engine)
        if save_to is not None:
            save_profile(profile, save_to)
        return cls(profile, cache=mcache, timer=counting, engine=engine,
                   calibration={
                       "source": f"calibrated:{fingerprint.id}",
                       "timings": counting.calls,
                       "cache_hits": mcache.hits if mcache else 0,
                       "count_traces": engine.trace_count,
                       "retimed": len(profile.retimed_rows),
                   })

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
        """Predict every item in one batched evaluation; zero timings.
        Duplicate items — identical (content signature, argument shapes)
        — are counted once and their rows shared, so a batch of 64
        requests over 8 distinct kernels costs 8 count lookups (and no
        counting pass when the count store is warm)."""
        items = list(items)
        if not items:
            return []
        self.predict_engine.resolve(model)      # fail fast, pre-counting
        kernel_names, rows = self._count_items(items, names)
        return self.predict_engine.predict_rows(
            rows, kernel_names, model=model, strict=strict)

    def try_predict_batch(self, items: Sequence[PredictItem], *,
                          model: Optional[str] = None,
                          names: Optional[Sequence[str]] = None,
                          strict: bool = True
                          ) -> List[Union[Prediction, PredictionError]]:
        """Per-item error mode of :meth:`predict_batch`: position *i* is
        item *i*'s :class:`Prediction` or its own
        :class:`PredictionError`, so one out-of-scope item never fails
        the batch (still one batched evaluation)."""
        items = list(items)
        if not items:
            return []
        self.predict_engine.resolve(model)
        kernel_names, rows = self._count_items(items, names)
        return self.predict_engine.try_predict_rows(
            rows, kernel_names, model=model, strict=strict)

    def audit(self, items: Optional[Sequence[PredictItem]] = None, *,
              model: Optional[str] = None):
        """Static modelability audit of this session — no kernel runs, no
        timings, only fake-tensor runs (the report's ``stats`` prove it).

        Audits the resolved fit's identifiability against the profile's
        held-out battery (when the profile carries one), plus — for each
        given predict item — the aten-level scope, cache-signature
        hazards, and any counted work outside the model's scope
        (``out-of-scope-feature``, the static twin of ``strict=True``
        prediction).  Returns a
        :class:`repro_torch.analysis.DiagnosticReport` whose ``stats``
        are ``{"timings": ..., "traces": ...}``: the timing passes the
        session's timer ran meanwhile (0) and the fake-tensor runs."""
        from repro_torch.analysis import Diagnostic, DiagnosticReport
        from repro_torch.analysis.identifiability import analyze_model
        from repro_torch.analysis.scope import abstract_args, audit_callable
        from repro_torch.analysis.sighazards import audit_signature
        from repro_torch.core.counting import count_fn

        timings_before = self.timer.calls
        fit_name, _mf, m = self.predict_engine.resolve(model)
        report = DiagnosticReport(stats={"timings": 0, "traces": 0})
        holdout = self.profile.holdout
        if holdout is not None and len(holdout):
            report.extend(analyze_model(
                m, m.align(holdout, missing="zero"),
                f"model:{fit_name}[holdout]"))
        for idx, item in enumerate(items or ()):
            kname, _key, _sig = _item_identity(item, idx)
            loc = f"kernel:{kname}"
            if isinstance(item, MeasurementKernel):
                fn, args = item.fn, abstract_args(item.make_args)
            elif isinstance(item, tuple):
                fn, args = item
            else:
                fn, args = item, ()
            report.extend(audit_callable(fn, args, loc,
                                         stats=report.stats))
            report.extend(audit_signature(fn, loc))
            try:
                counts = count_fn(fn, *args)
                report.stats["traces"] += 1
            except Exception:   # noqa: BLE001 — already diagnosed above
                continue
            extra = m.unmodeled_features(counts)
            if extra:
                report.extend([Diagnostic(
                    "warning", "out-of-scope-feature", loc,
                    f"kernel performs counted work model {fit_name!r} "
                    f"has no term for: {', '.join(sorted(extra))} — "
                    f"predictions silently omit that cost "
                    f"(strict=True prediction would refuse)",
                    details={"features": sorted(extra),
                             "model": fit_name})])
        report.stats["timings"] = self.timer.calls - timings_before
        return report

    def _count_items(self, items: Sequence[PredictItem],
                     names: Optional[Sequence[str]]
                     ) -> Tuple[List[str], List[FeatureCounts]]:
        """Resolve each item's identity, dedup by (signature, shapes) and
        count through the cache and the count engine — never a timer."""
        if names is not None and len(names) != len(items):
            raise ValueError(f"names has {len(names)} entries for "
                             f"{len(items)} items")
        kernel_names: List[str] = []
        rows: List[FeatureCounts] = []
        deduped: Dict[Any, FeatureCounts] = {}
        for idx, item in enumerate(items):
            kname, key, sig = _item_identity(item, idx)
            kernel_names.append(names[idx] if names is not None else kname)
            counts = deduped.get(key)
            if counts is None:
                counts = self._counts_of(item, sig)
                deduped[key] = counts
            rows.append(counts)
        return kernel_names, rows

    def _counts_of(self, item: PredictItem, sig: str) -> FeatureCounts:
        """One item's counted features, through the measurement cache and
        the count engine."""
        if isinstance(item, MeasurementKernel):
            if self.cache is None:
                return self.engine.counts_for(item, sig=sig)
            trials = self.profile.trials
            entry = self.cache.get(item, trials)
            if entry is not None:
                return entry.counts
            counts = self.engine.counts_for(item, sig=sig)
            # a counts-only entry: a later gather backfills the timing
            self.cache.put(item, trials, None, counts)
            return counts
        fn, args = item if isinstance(item, tuple) else (item, ())
        return self.engine.counts_of_callable(fn, args, sig=sig)


def _item_identity(item: PredictItem, idx: int
                   ) -> Tuple[str, Any, str]:
    """Display name, dedup key and content signature of one predict item.
    The key is the item's content identity — (signature, shapes) — so
    identical requests in a batch collapse to one lookup; with a ``""``
    signature it falls back to object identity, sound within a batch."""
    if isinstance(item, MeasurementKernel):
        sig = item.code_sig or callable_signature(item.fn)
        return item.name, ("kern", sig or f"obj:{id(item.fn)}", item.name,
                           tuple(sorted(item.sizes.items()))), sig
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
    if kname == "<lambda>":
        kname = "kernel"
    sig = callable_signature(fn)
    key = ("fn", sig or f"obj:{id(fn)}", args_signature(args))
    return f"{kname}[{idx}]", key, sig


def _as_counting_timer(timer) -> CountingTimer:
    if isinstance(timer, CountingTimer):
        return timer
    return CountingTimer(timer) if timer is not None else CountingTimer()


def _check_fingerprint(profile: MachineProfile,
                       expected: Optional[DeviceFingerprint]) -> None:
    if expected is not None and profile.fingerprint != expected:
        raise ProfileError(
            f"profile was calibrated on {profile.fingerprint.id!r} but "
            f"{expected.id!r} was required; recalibrate with "
            f"`python -m repro_torch.calibrate`")


def _as_cache(cache, fingerprint) -> Optional[MeasurementCache]:
    if cache is None or isinstance(cache, MeasurementCache):
        return cache
    return MeasurementCache(cache, fingerprint)
