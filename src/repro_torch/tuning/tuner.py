"""Predictor-guided variant search — the paper's autotuner-pruning loop,
the counterpart of ``repro.tuning.tuner``.

The paper's §4 headline use case, closed end-to-end:

1. **Price** the entire enumerated space in ONE batched
   ``predict_batch`` evaluation (family-polynomial counts: zero counting
   passes against a warm count store, zero timings always).
2. **Prune** to a top-k candidate set (absolute or fractional), widened
   by an uncertainty margin derived from the fit's held-out gmre so
   near-ties the model cannot distinguish survive to confirmation.
3. **Confirm** only the survivors with real timings, routed through the
   shared :class:`~repro_torch.profiles.MeasurementCache`
   (already-measured variants cost zero timing passes).  On the card a
   timing pass is the session timer's: one CUDA-graph replay per trial
   between CUDA events (:meth:`MeasurementKernel.time_stats`).
4. **Record** the winner as a :class:`~repro_torch.profiles.TunedChoice`
   in ``MachineProfile.tuning`` — a warm re-tune of the same space is a
   pure dictionary lookup: zero timings, zero counting passes, zero
   batched evaluations, all assertable via the session's counters.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.uipick import MeasurementKernel, TimingStats
from repro_torch.profiles.profile import TunedChoice
from repro_torch.tuning.space import TuningSpace

# prune widening when the fit carries no held-out accuracy estimate
# (e.g. an exact synthetic profile): a flat 5% near-tie band
DEFAULT_MARGIN = 0.05
# cap: a terrible fit must not widen the band into "time everything"
MAX_MARGIN = 0.5


class TuningError(RuntimeError):
    """A search that cannot produce a trustworthy winner."""


@dataclass
class TuneResult:
    """Outcome of one :func:`tune_space` call.  ``choice`` is the
    persisted artifact; the rest is this run's receipts — how many
    timing passes were actually paid (``timings_performed`` excludes
    measurement-cache hits, unlike ``choice.n_timed`` which counts
    confirmed survivors) and whether the warm path short-circuited."""

    choice: TunedChoice
    warm: bool
    timings_performed: int
    survivors: List[str] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def winner(self) -> str:
        return self.choice.winner


def prune_candidates(predicted: Sequence[float], *,
                     top_fraction: float = 0.2,
                     top_k: Optional[int] = None,
                     margin: float = 0.0) -> List[int]:
    """Indices surviving the prune, cheapest-predicted first.

    Keeps exactly the top-k (``top_k`` absolute, else
    ``ceil(top_fraction · n)``, at least one), then — when ``margin`` is
    positive — everything predicted within ``margin`` of the k-th
    survivor: candidates the model's own accuracy cannot separate from
    the cut line deserve a confirmation timing, not a silent drop.
    """
    n = len(predicted)
    if n == 0:
        return []
    if not 0.0 < top_fraction <= 1.0:
        raise ValueError(f"top_fraction must be in (0, 1], "
                         f"got {top_fraction}")
    if margin < 0.0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    k = top_k if top_k is not None else math.ceil(top_fraction * n)
    k = max(1, min(n, int(k)))
    order = sorted(range(n), key=lambda i: (predicted[i], i))
    keep = order[:k]
    if margin > 0.0:
        cutoff = predicted[keep[-1]] * (1.0 + margin)
        keep = keep + [i for i in order[k:] if predicted[i] <= cutoff]
    return keep


def derive_margin(holdout_gmre: Optional[float]) -> float:
    """Prune margin from the fit's held-out geometric-mean relative
    error: two error widths of slack, capped.  ``None`` (no holdout —
    e.g. an exact synthetic profile) falls back to a flat band."""
    if holdout_gmre is None:
        return DEFAULT_MARGIN
    return min(MAX_MARGIN, 2.0 * float(holdout_gmre))


def confirm_time(kernel: MeasurementKernel, trials: int, *,
                 cache=None, timer=None, engine=None
                 ) -> Tuple[float, bool]:
    """One variant's confirmation time, through the measurement cache.

    Returns ``(median_seconds, timed)`` where ``timed`` says a real
    timing pass ran — a cache hit with a wall time costs nothing.  Fresh
    measurements are written back (with their noise) so the next search,
    gather, or exhaustive baseline reuses them; counts for the cache
    entry come from the (symbolic, memoized) count engine when one is
    threaded in, so confirmation never forces a counting pass the
    pricing step didn't already pay.  Without a ``timer`` the kernel is
    timed on the card (:func:`~repro_torch.core.uipick.default_timer`).
    """
    if cache is not None:
        entry = cache.get(kernel, trials)
        if entry is not None and entry.wall_time is not None:
            return float(entry.wall_time), False
    if timer is None:
        from repro_torch.core.uipick import default_timer
        timer = default_timer
    stats = TimingStats.coerce(timer(kernel, trials))
    if cache is not None:
        counts = (engine.counts_for(kernel) if engine is not None
                  else kernel.counts())
        cache.put(kernel, trials, stats.median, counts, noise=stats)
    return float(stats.median), True


def tune_space(session, space: TuningSpace, *,
               model: Optional[str] = None,
               top_fraction: float = 0.2,
               top_k: Optional[int] = None,
               margin: Optional[float] = None,
               trials: Optional[int] = None,
               force: bool = False,
               record: bool = True) -> TuneResult:
    """Search ``space`` with ``session``'s calibrated model.

    Warm path first: a :class:`~repro_torch.profiles.TunedChoice` already
    recorded for this space signature (and the same resolved fit) is
    returned as-is — zero timings, zero counting passes, zero batched
    evaluations (``force=True`` re-searches anyway).  Cold path: one
    batched pricing evaluation over the whole space, prune, confirm
    survivors through the measurement cache, record the winner.
    """
    t0 = time.perf_counter()
    fit_name, _mf, _m = session.predict_engine.resolve(model)
    if trials is None:
        trials = session.profile.trials or 8
    stored = session.profile.tuning.get(space.signature)
    if stored is not None and stored.model == fit_name and not force:
        return TuneResult(choice=stored, warm=True, timings_performed=0,
                          survivors=sorted(stored.measured),
                          wall_s=time.perf_counter() - t0)

    timer_before = session.timer.calls
    preds = session.predict_batch(list(space.kernels), model=fit_name,
                                  names=space.variant_names)
    predicted = {p.kernel: float(p.seconds) for p in preds}
    pred_s = [float(p.seconds) for p in preds]
    if margin is None:
        margin = derive_margin(preds[0].diagnostics.get("holdout_gmre"))
    survivors = prune_candidates(pred_s, top_fraction=top_fraction,
                                 top_k=top_k, margin=margin)

    measured: Dict[str, float] = {}
    for i in survivors:
        k = space.kernels[i]
        seconds, _timed = confirm_time(k, trials, cache=session.cache,
                                       timer=session.timer,
                                       engine=session.engine)
        measured[k.name] = seconds
    timings_spent = session.timer.calls - timer_before

    # measured-fastest survivor; predicted time, then enumeration order,
    # break exact measurement ties deterministically
    winner_i = min(survivors,
                   key=lambda i: (measured[space.kernels[i].name],
                                  pred_s[i], i))
    winner = space.kernels[winner_i]
    choice = TunedChoice(
        space_signature=space.signature,
        space_name=space.name,
        model=fit_name,
        winner=winner.name,
        predicted_s=pred_s[winner_i],
        measured_s=measured[winner.name],
        n_variants=len(space),
        n_timed=len(survivors),
        timings_spent=timings_spent,
        trials=trials,
        margin=float(margin),
        tags=list(space.tags),
        predicted=predicted,
        measured=dict(measured),
    )
    if record:
        session.profile.tuning[space.signature] = choice
    return TuneResult(choice=choice, warm=False,
                      timings_performed=timings_spent,
                      survivors=[space.kernels[i].name for i in survivors],
                      wall_s=time.perf_counter() - t0)


def true_optimal_set(device, space: TuningSpace, *,
                     rtol: float = 1e-6) -> List[str]:
    """Ground-truth-optimal variant names of ``space`` on a synthetic
    device (exact ties — e.g. deduplicate-proof identical lowerings —
    are all optimal).  Only meaningful for devices whose timing law is
    known; the tests assert the pruned search's winner lands in this
    set."""
    times = {k.name: float(device.true_time(k)) for k in space.kernels}
    best = min(times.values())
    return sorted(n for n, t in times.items() if t <= best * (1.0 + rtol))


def exhaustive_search(session, space: TuningSpace, *,
                      trials: Optional[int] = None,
                      use_cache: bool = True
                      ) -> Tuple[str, Dict[str, float], int]:
    """Time EVERY variant — the baseline the pruned search is judged
    against.  Returns ``(winner, measured, timings_performed)``.
    ``use_cache=False`` forces fresh timings (fair wall-clock baseline
    in benchmarks that just warmed the cache with the pruned run)."""
    if trials is None:
        trials = session.profile.trials or 8
    timer_before = session.timer.calls
    measured: Dict[str, float] = {}
    for k in space.kernels:
        seconds, _timed = confirm_time(
            k, trials,
            cache=session.cache if use_cache else None,
            timer=session.timer, engine=session.engine)
        measured[k.name] = seconds
    winner = min(sorted(measured), key=lambda n: measured[n])
    return winner, measured, session.timer.calls - timer_before
