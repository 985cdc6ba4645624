"""Deterministic discrete-event simulation of a routed synthetic fleet;
the counterpart of ``repro.fleet.sim``.

The router's claim — model-guided placement beats model-blind placement
on heterogeneous hardware — needs a fleet to be checked against.
:class:`~repro_torch.testing.synthdev.SyntheticDevice` supplies the
hardware (fake machines with known timing laws); this module supplies
the workload: :func:`heavy_tailed_jobs` builds a deterministic arrival
stream over the UIPiCK battery whose cost distribution is heavy-tailed
(mostly cheap kernels, a fat tail of matmuls orders of magnitude
dearer), and :func:`simulate_fleet` plays the stream through a
:class:`~repro_torch.fleet.FleetRouter` against ground-truth service
times.

Every random draw is a :func:`~repro_torch.core.uipick.unit_hash` of
the job's identity (the reference's definition, so both packages draw
the same stream), service times come from the devices' truth laws
(evaluated in float64, memoized per machine and kernel), and the
router's tie-breaks are fleet order — so two runs of one scenario give
byte-identical reports, and "predictive makespan ≤ round-robin
makespan" is a hard gate rather than a statistical one.

A :class:`Degradation` makes a device's observed service times drift
from its (stale) profile mid-run; completions feed observed-vs-predicted
skew back through :meth:`FleetRouter.complete`, the machine's routing
weight demotes, the recalibration flag latches, and — when a
``recalibrate_fn`` is given — a fresh session is swapped in.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

from repro_torch.core.uipick import (
    ALL_GENERATORS,
    KernelCollection,
    MatchCondition,
    MeasurementKernel,
    unit_hash,
)
from repro_torch.studies.zoo import STUDY_SMOKE_TAGS
from repro_torch.testing.synthdev import SyntheticDevice, fleet_device

__all__ = ["Degradation", "Job", "SimReport", "heavy_tailed_jobs",
           "simulate_fleet"]

#: default workload battery: the CI-sized three-class battery (flop-heavy
#: matmuls, memory streams, empty kernels) — cost spans ~5 orders of
#: magnitude, which is the heavy tail
SIM_TAGS: Tuple[str, ...] = tuple(STUDY_SMOKE_TAGS)

#: reference rates used ONLY to rank battery kernels by a cost proxy when
#: building the job mix (the sorted order, not the absolute values, is
#: what matters) — the default fleet's "apex" machine
_REFERENCE_DEVICE = "apex"


@dataclass(frozen=True)
class Job:
    """One workload arrival: which kernel, and when it shows up."""

    index: int
    kernel: MeasurementKernel
    arrival_s: float


@dataclass(frozen=True)
class Degradation:
    """A device silently slowing down mid-run: observed service times are
    multiplied by ``factor`` from ``after_s`` on, while its PROFILE (what
    the router predicts with) still describes the healthy machine — the
    scenario the health loop exists for."""

    machine: str
    factor: float
    after_s: float = 0.0

    def __post_init__(self):
        if not self.factor > 0.0:
            raise ValueError(f"degradation factor must be positive, "
                             f"got {self.factor}")


@dataclass
class SimReport:
    """One simulated scenario's outcome, deterministic and JSON-ready."""

    policy: str
    n_jobs: int
    makespan_s: float
    per_machine: Dict[str, Dict[str, float]] = field(default_factory=dict)
    routing_timings: int = 0            # kernel timings spent routing: 0
    decisions: int = 0
    recalibration_flagged: List[str] = field(default_factory=list)
    recalibrated: List[str] = field(default_factory=list)
    weights: Dict[str, float] = field(default_factory=dict)
    health: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "n_jobs": self.n_jobs,
            "makespan_s": self.makespan_s,
            "per_machine": {m: dict(sorted(v.items()))
                            for m, v in sorted(self.per_machine.items())},
            "routing_timings": self.routing_timings,
            "decisions": self.decisions,
            "recalibration_flagged": list(self.recalibration_flagged),
            "recalibrated": list(self.recalibrated),
            "weights": dict(sorted(self.weights.items())),
            "health": {m: dict(sorted(v.items()))
                       for m, v in sorted(self.health.items())},
        }


def _truth_law(device: SyntheticDevice) -> Callable[[MeasurementKernel],
                                                     float]:
    """``kernel → noise-free truth seconds`` on ``device``: the model is
    built once and each kernel's time evaluated once (a
    :meth:`SyntheticDevice.true_time` call builds a fresh model)."""
    model = device.truth_model()
    memo: Dict[str, float] = {}

    def law(kernel: MeasurementKernel) -> float:
        t = memo.get(kernel.name)
        if t is None:
            t = memo[kernel.name] = float(
                model.evaluate(device.p_true, kernel.counts()))
        return t

    return law


# ---------------------------------------------------------------------------
# Workload synthesis
# ---------------------------------------------------------------------------

def heavy_tailed_jobs(n_jobs: int, *,
                      tags: Sequence[str] = SIM_TAGS,
                      mean_interarrival_s: Optional[float] = None,
                      n_machines: int = 1,
                      tail: float = 2.5,
                      seed: str = "fleet-sim") -> List[Job]:
    """A deterministic heavy-tailed job stream over the UIPiCK battery.

    The battery is sorted by a reference cost proxy (the default fleet's
    ``apex`` truth model over each kernel's counts) and job *i* picks
    index ``⌊len · u^tail⌋`` with ``u = unit_hash(seed, "job", i)`` —
    most draws land on cheap kernels, a hash-deterministic few land deep
    in the expensive tail; since battery cost grows geometrically across
    the sorted order, the resulting service-time distribution is heavy
    tailed.  Inter-arrival gaps are exponential
    (``-mean · ln(1 - v)``); the default mean loads ``n_machines``
    reference machines at roughly 2× aggregate capacity, so queues
    actually form and placement decisions have consequences — pass the
    FLEET size, or a many-machine fleet drains every arrival instantly
    and all policies tie on makespan.

    Only abstract counting happens here — no kernel is ever executed.
    """
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if not tail >= 1.0:
        raise ValueError(f"tail must be >= 1 (1 = uniform mix), got {tail}")
    if n_machines < 1:
        raise ValueError(f"n_machines must be >= 1, got {n_machines}")
    battery = KernelCollection(ALL_GENERATORS).generate_kernels(
        list(tags), MatchCondition.INTERSECT)
    if not battery:
        raise ValueError(f"no battery kernels match tags {list(tags)!r}")
    ref_law = _truth_law(fleet_device(_REFERENCE_DEVICE))
    costed = sorted(((ref_law(k), k.name, k) for k in battery),
                    key=lambda t: t[:2])
    picks: List[Tuple[float, MeasurementKernel]] = []
    for i in range(n_jobs):
        u = unit_hash(seed, "job", i)
        cost, _name, kernel = costed[min(len(costed) - 1,
                                         int(len(costed) * u ** tail))]
        picks.append((cost, kernel))
    if mean_interarrival_s is None:
        mean_cost = sum(c for c, _k in picks) / len(picks)
        # ~2× the aggregate capacity of n_machines reference machines
        mean_interarrival_s = mean_cost / (2.0 * n_machines)
    if not mean_interarrival_s > 0.0:
        raise ValueError(f"mean_interarrival_s must be positive, "
                         f"got {mean_interarrival_s}")
    jobs: List[Job] = []
    t = 0.0
    for i, (_cost, kernel) in enumerate(picks):
        v = unit_hash(seed, "gap", i)
        t += -mean_interarrival_s * math.log(max(1.0 - v, 1e-12))
        jobs.append(Job(index=i, kernel=kernel, arrival_s=t))
    return jobs


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------

def simulate_fleet(router: Optional[Any],
                   devices: Mapping[str, SyntheticDevice],
                   jobs: Sequence[Job], *,
                   degradations: Sequence[Degradation] = (),
                   recalibrate_fn: Optional[Callable[[str], Any]] = None,
                   oracle: bool = False) -> SimReport:
    """Play ``jobs`` through ``router`` against ground-truth service
    times from ``devices`` (keyed by the router's machine names, i.e.
    fingerprint ids).

    The event loop is exact, not sampled: jobs are routed in arrival
    order, completions that finish before an arrival are fed back to the
    router first (``complete`` drains the ledger and reports
    observed-vs-predicted skew to the health layer), each machine runs
    its queue FIFO, and the makespan is the last completion time.

    ``oracle=True`` bypasses the router entirely and places each job on
    the machine minimizing TRUE completion time (queue + ground-truth
    service) — the clairvoyant lower bound benchmarks compare against;
    ``router`` may be ``None`` in that mode.

    ``recalibrate_fn(machine)`` is invoked when the health layer flags a
    machine; returning a fresh ``PerfSession`` swaps it into the router
    (closing the recalibration loop mid-run), returning ``None`` records
    the flag and routes on, demoted.
    """
    if not oracle and router is None:
        raise ValueError("simulate_fleet needs a router unless oracle=True")
    machines = list(devices) if oracle and router is None \
        else list(router.machines)
    for m in machines:
        if m not in devices:
            raise KeyError(
                f"router machine {m!r} has no synthetic device; "
                f"devices: {sorted(devices)}")
    # memoized truth laws — SyntheticDevice.true_time() builds a fresh
    # Model per call, which would dominate the loop at thousands of jobs
    truths = {m: _truth_law(devices[m]) for m in machines}
    degrade = {d.machine: d for d in degradations}
    for m in degrade:
        if m not in devices:
            raise KeyError(f"degradation names unknown machine {m!r}")

    free_at = {m: 0.0 for m in machines}
    busy_s = {m: 0.0 for m in machines}
    n_placed = {m: 0 for m in machines}
    # (finish_t, seq, machine, predicted_s, observed_s)
    completions: List[Tuple[float, int, str, float, float]] = []
    makespan = 0.0
    recalibrated: List[str] = []

    def service_time(machine: str, job: Job, start: float) -> float:
        t = truths[machine](job.kernel)
        d = degrade.get(machine)
        if d is not None and start >= d.after_s:
            t *= d.factor
        return t

    def drain(until: float) -> None:
        while completions and completions[0][0] <= until:
            _t, _seq, m, predicted_s, observed_s = \
                heapq.heappop(completions)
            if router is not None:
                router.complete(m, predicted_s=predicted_s,
                                observed_s=observed_s)
                if recalibrate_fn is not None:
                    for flagged in router.health.needs_recalibration():
                        if flagged in recalibrated:
                            continue
                        fresh = recalibrate_fn(flagged)
                        if fresh is not None:
                            router.replace_session(flagged, fresh)
                            recalibrated.append(flagged)

    seq = 0
    for job in jobs:
        drain(job.arrival_s)
        if oracle:
            chosen = min(
                machines,
                key=lambda m: (max(job.arrival_s, free_at[m])
                               + service_time(m, job,
                                              max(job.arrival_s,
                                                  free_at[m])),
                               machines.index(m)))
            predicted_s = 0.0
        else:
            decision = router.route(job.kernel, name=job.kernel.name)
            chosen = decision.machine
            predicted_s = decision.predicted_s
        start = max(job.arrival_s, free_at[chosen])
        observed = service_time(chosen, job, start)
        finish = start + observed
        free_at[chosen] = finish
        busy_s[chosen] += observed
        n_placed[chosen] += 1
        makespan = max(makespan, finish)
        heapq.heappush(completions,
                       (finish, seq, chosen, predicted_s, observed))
        seq += 1
    drain(math.inf)

    if oracle and router is None:
        policy, timings, decisions = "oracle", 0, len(jobs)
        flagged, weights, health = [], {}, {}
    else:
        policy = "oracle" if oracle else router.policy
        timings = router.timings()
        decisions = router.decisions if not oracle else len(jobs)
        flagged = router.health.needs_recalibration()
        weights = {m: router.health.weight(m) for m in machines}
        health = router.health.report()
    return SimReport(
        policy=policy, n_jobs=len(jobs), makespan_s=makespan,
        per_machine={m: {"jobs": float(n_placed[m]),
                         "busy_s": busy_s[m]} for m in machines},
        routing_timings=timings, decisions=decisions,
        recalibration_flagged=flagged, recalibrated=recalibrated,
        weights=weights, health=health)
