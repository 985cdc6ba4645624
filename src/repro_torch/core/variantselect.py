"""Model-guided variant selection — the paper's autotuner-pruning use
case, the counterpart of ``repro.core.variantselect``.

Given a calibrated cost model and a set of mathematically equivalent
program variants, predict each variant's execution time from its
automatically gathered features and rank them — no execution of the
candidate variants required (paper §4: "an effective pruning strategy").

This module is a thin compatibility layer over
:mod:`repro_torch.tuning`, the full search engine (space enumeration,
one-batched-eval pricing, top-k pruning, cached confirmation, persisted
winners).  ``rank_variants``/``select_variant`` warn once per process
(:class:`DeprecationWarning`); new code should drive
:func:`repro_torch.tuning.tune_space` through a
:class:`~repro_torch.api.PerfSession`.

A :class:`Variant`'s ``make_args(device)`` is a measurement kernel's
builder: it is counted on ``meta`` arguments and, when measured, timed
through the caller's timer.

There is deliberately no module-level count engine: counting state is
threaded from the caller (pass ``engine=session.engine`` to reuse a
session's persistent count store), and a caller that passes nothing gets
a private engine per call — never a hidden process-wide cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.core.calibrate import FitResult
from repro_torch.core.countengine import CountEngine
from repro_torch.core.model import DTYPE, Model


@dataclass
class Variant:
    name: str
    fn: Callable
    make_args: Callable[..., tuple]
    meta: Dict = field(default_factory=dict)


@dataclass
class RankedVariant:
    name: str
    predicted_time: float
    measured_time: Optional[float] = None


def predict_time(model: Model, params: Mapping[str, float],
                 variant: Variant, *,
                 engine: Optional[CountEngine] = None) -> float:
    """One variant's predicted seconds (single-row convenience; batch
    ranking goes through the batched evaluator in :func:`rank_variants`
    / :func:`repro_torch.tuning.tune_space`)."""
    eng = engine if engine is not None else CountEngine()
    counts = eng.counts_of_callable(variant.fn, variant.make_args("meta"))
    p_vec = torch.as_tensor([params[n] for n in model.param_names],
                            dtype=DTYPE)
    features = torch.as_tensor(model.align(counts), dtype=DTYPE)
    return float(model.batched_eval(p_vec, features)[0])


def _rank(model: Model, params: Mapping[str, float] | FitResult,
          variants: Sequence[Variant], *,
          measure: bool, trials: int,
          engine: Optional[CountEngine],
          cache=None, timer=None) -> List[RankedVariant]:
    # lazy: core must not import the api/tuning layers at module scope
    from repro_torch.api.engine import PredictEngine
    from repro_torch.core.uipick import MeasurementKernel
    from repro_torch.profiles.fingerprint import DeviceFingerprint
    from repro_torch.profiles.profile import MachineProfile, ModelFit
    from repro_torch.tuning.tuner import confirm_time

    if isinstance(params, FitResult):
        params = params.params
    eng = engine if engine is not None else CountEngine()
    counts_rows = [eng.counts_of_callable(v.fn, v.make_args("meta"))
                   for v in variants]
    # one batched evaluation over an ad-hoc single-fit profile — the
    # same pricing path tune_space uses, minus the session
    profile = MachineProfile(
        fingerprint=DeviceFingerprint(platform="adhoc",
                                      device_kind="variantselect",
                                      n_devices=1),
        fits={"adhoc": ModelFit.from_fit(model, FitResult(
            params=dict(params), residual_norm=0.0, iterations=0,
            converged=True))})
    preds = PredictEngine(profile).predict_rows(
        counts_rows, [v.name for v in variants], model="adhoc")
    out = []
    for v, pred in zip(variants, preds):
        meas = None
        if measure:
            mk = MeasurementKernel(v.name, v.fn, v.make_args, {})
            meas, _timed = confirm_time(mk, trials, cache=cache,
                                        timer=timer, engine=eng)
        out.append(RankedVariant(v.name, float(pred.seconds), meas))
    return sorted(out, key=lambda r: r.predicted_time)


def rank_variants(
    model: Model,
    params: Mapping[str, float] | FitResult,
    variants: Sequence[Variant],
    *,
    measure: bool = False,
    trials: int = 10,
    engine: Optional[CountEngine] = None,
    cache=None,
    timer=None,
) -> List[RankedVariant]:
    """Deprecated: rank ``variants`` by predicted time (one batched
    evaluation), optionally confirming each with a measurement routed
    through ``cache`` (a :class:`~repro_torch.profiles.MeasurementCache`)
    and timed by ``timer`` (on the card when none is given).  Prefer
    :func:`repro_torch.tuning.tune_space`, which also prunes before
    measuring and records the winner."""
    from repro_torch.deprecation import warn_once
    warn_once("variantselect.rank_variants",
              "rank_variants is deprecated; use "
              "repro_torch.tuning.tune_space (prices the space in one "
              "batched evaluation, times only the pruned top-k, and "
              "records the winner in the profile)")
    return _rank(model, params, variants, measure=measure, trials=trials,
                 engine=engine, cache=cache, timer=timer)


def select_variant(model, params, variants, *,
                   engine: Optional[CountEngine] = None) -> Variant:
    """Deprecated: the predicted-fastest variant, no measurements.
    Prefer :func:`repro_torch.tuning.tune_space` (which confirms its
    winner)."""
    from repro_torch.deprecation import warn_once
    warn_once("variantselect.select_variant",
              "select_variant is deprecated; use "
              "repro_torch.tuning.tune_space and read the recorded "
              "TunedChoice winner")
    ranked = _rank(model, params, variants, measure=False, trials=0,
                   engine=engine)
    best = ranked[0].name
    return next(v for v in variants if v.name == best)


def ranking_quality(ranked: Sequence[RankedVariant]) -> Dict[str, float]:
    """Did the model rank the measured-fastest variant first?  Top-1 is
    judged among MEASURED entries only (an unmeasured head of the
    ranking proves nothing), pairwise agreement is Kendall-tau-style
    over measured pairs, and ``n_measured`` says how much evidence the
    scores rest on — fewer than two measurements makes both vacuously
    1.0."""
    with_meas = [r for r in ranked if r.measured_time is not None]
    if len(with_meas) < 2:
        return {"top1_correct": 1.0, "pairwise_agreement": 1.0,
                "n_measured": float(len(with_meas))}
    best_measured = min(with_meas, key=lambda r: r.measured_time)
    # with_meas preserves ranking order, so its head is the
    # best-predicted variant that actually has a measurement
    top1 = 1.0 if with_meas[0].name == best_measured.name else 0.0
    agree = tot = 0
    for i in range(len(with_meas)):
        for j in range(i + 1, len(with_meas)):
            a, b = with_meas[i], with_meas[j]
            pred_order = a.predicted_time <= b.predicted_time
            meas_order = a.measured_time <= b.measured_time
            agree += int(pred_order == meas_order)
            tot += 1
    return {"top1_correct": top1, "pairwise_agreement": agree / tot,
            "n_measured": float(len(with_meas))}
