"""``FleetRouter`` — model-guided load balancing across machine
profiles; the counterpart of ``repro.fleet.router``.

The paper's first motivating use case for cheap cross-machine models is
load balancing and job scheduling: with one calibrated profile per
machine, an incoming workload is priced on every machine of a
heterogeneous fleet without running anything — one batched
``predict_batch`` evaluation per machine, zero kernel timings — and
routed to whichever machine the model says will finish it first.

The router composes three ledgers:

* **predictions** — each machine's open
  :class:`~repro_torch.api.PerfSession` (opened through the serving
  :class:`~repro_torch.serving.SessionPool`, or wrapped directly around
  in-memory profiles) prices the workload; all sessions share one
  :class:`~repro_torch.core.countengine.CountEngine`, so a fleet of N
  machines costs one count per unique kernel, not N;
* **outstanding load** — predicted seconds of dispatched but uncompleted
  work per machine, charged by :meth:`route` and drained by
  :meth:`complete`;
* **health** — a :class:`~repro_torch.fleet.health.FleetHealth` skew
  tracker fed by ``complete(observed_s=...)``.

Policies (``POLICIES``): ``round_robin`` ignores the model (the
baseline), ``cheapest`` minimizes the workload's own predicted cost,
``least_loaded`` the backlog, and ``predicted_makespan`` (default) the
predicted completion time ``(outstanding + predicted) / weight``.

Sessions and health serialize internally, and the router's own ledgers
are guarded by one lock, so daemon handler threads may route and
complete concurrently.  :meth:`recalibrate` is the router's only timing
path; on ``None`` it studies the local card (``device="cuda"`` unless the
caller passes another) and raises when none is visible.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple, Union

from repro_torch.api import PerfSession
from repro_torch.core.countengine import CountEngine
from repro_torch.fleet.health import FleetHealth

__all__ = ["DEFAULT_POLICY", "POLICIES", "FleetRouter", "RoutingDecision"]

#: routing policies, in documentation order
POLICIES: Tuple[str, ...] = ("round_robin", "cheapest", "least_loaded",
                             "predicted_makespan")
DEFAULT_POLICY = "predicted_makespan"


@dataclass(frozen=True)
class RoutingDecision:
    """One routed workload: where it went and why.

    ``predicted`` is the raw model prediction per machine (seconds);
    ``scores`` is the policy objective each machine was ranked by (lower
    wins — for ``predicted_makespan`` that is the weighted predicted
    completion time); ``outstanding`` and ``weights`` are the ledger and
    health snapshots the decision was made against.
    """

    kernel: str
    machine: str
    policy: str
    predicted_s: float
    predicted: Dict[str, float]
    scores: Dict[str, float]
    outstanding: Dict[str, float]
    weights: Dict[str, float]
    seq: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel,
            "machine": self.machine,
            "policy": self.policy,
            "predicted_s": self.predicted_s,
            "predicted": dict(sorted(self.predicted.items())),
            "scores": dict(sorted(self.scores.items())),
            "outstanding": dict(sorted(self.outstanding.items())),
            "weights": dict(sorted(self.weights.items())),
            "seq": self.seq,
        }


class FleetRouter:
    """Price a workload on every machine's calibrated model; route it to
    the machine predicted to finish it first."""

    def __init__(self, sessions: Mapping[str, PerfSession], *,
                 policy: str = DEFAULT_POLICY,
                 health: Optional[FleetHealth] = None,
                 pool: Optional[Any] = None):
        if not sessions:
            raise ValueError("a fleet router needs at least one machine")
        _check_policy(policy)
        # insertion order is the deterministic tie-break everywhere
        self._sessions: "OrderedDict[str, PerfSession]" = \
            OrderedDict(sessions)
        self.policy = policy
        self.health = health if health is not None else FleetHealth()
        self._pool = pool          # closed with the router when present
        self._lock = threading.Lock()
        self._outstanding: Dict[str, float] = \
            {m: 0.0 for m in self._sessions}
        self._dispatched: Dict[str, int] = {m: 0 for m in self._sessions}
        self._completed: Dict[str, int] = {m: 0 for m in self._sessions}
        self._rr = 0
        self.decisions = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def open(cls, profile_paths: Sequence[Union[str, Path]], *,
             cache: Union[None, str, Path] = None,
             policy: str = DEFAULT_POLICY,
             health: Optional[FleetHealth] = None,
             max_wait_s: float = 0.002) -> "FleetRouter":
        """Open one session per profile path through a
        :class:`~repro_torch.serving.SessionPool` sized to keep the WHOLE
        fleet open (routing re-prices every machine per request —
        evicting one would thrash).  Zero measurements: opening from a path never
        times a kernel.  All sessions share one count engine (persisted
        under ``cache`` when given), so a workload is counted once for
        the whole fleet."""
        from repro_torch.serving.pool import SessionPool

        paths = [str(p) for p in profile_paths]
        if not paths:
            raise ValueError("a fleet router needs at least one profile")
        store = Path(cache).expanduser() / "countengine" \
            if isinstance(cache, (str, Path)) else None
        engine = CountEngine(store=store)

        def factory(path: str, *, cache=None) -> PerfSession:
            return PerfSession.open(path, cache=cache, engine=engine)

        pool = SessionPool(max_open=len(paths), cache=cache,
                           session_factory=factory, max_wait_s=max_wait_s)
        sessions: "OrderedDict[str, PerfSession]" = OrderedDict()
        for p in paths:
            session, _batcher = pool.get(p)
            name = session.profile.fingerprint.id
            if name in sessions:
                pool.close()
                raise ValueError(
                    f"two fleet profiles describe the same machine "
                    f"{name!r} — a router needs one profile per machine "
                    f"(merge same-machine profiles first)")
            sessions[name] = session
        return cls(sessions, policy=policy, health=health, pool=pool)

    @classmethod
    def from_profiles(cls, profiles: Iterable[Any], *,
                      policy: str = DEFAULT_POLICY,
                      health: Optional[FleetHealth] = None,
                      engine: Optional[CountEngine] = None
                      ) -> "FleetRouter":
        """Wrap in-memory :class:`~repro_torch.profiles.MachineProfile` objects
        (e.g. a loaded fleet bundle, or ``run_study`` results still in
        hand) — the study → routing handoff without touching disk."""
        shared = engine if engine is not None else CountEngine()
        sessions: "OrderedDict[str, PerfSession]" = OrderedDict()
        for prof in profiles:
            name = prof.fingerprint.id
            if name in sessions:
                raise ValueError(
                    f"two fleet profiles describe the same machine "
                    f"{name!r} — a router needs one profile per machine")
            sessions[name] = PerfSession.open(prof, engine=shared)
        return cls(sessions, policy=policy, health=health)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def machines(self) -> List[str]:
        return list(self._sessions)

    def session(self, machine: str) -> PerfSession:
        if machine not in self._sessions:
            raise KeyError(f"unknown machine {machine!r}; "
                           f"fleet: {self.machines}")
        return self._sessions[machine]

    def outstanding(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._outstanding)

    def timings(self) -> int:
        """Total kernel-timing passes across every session — stays 0 on
        the routing path (the CountingTimer-assertable guarantee)."""
        return sum(s.timer.calls for s in self._sessions.values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._outstanding)
            dispatched = dict(self._dispatched)
            completed = dict(self._completed)
            decisions = self.decisions
        return {
            "machines": self.machines,
            "policy": self.policy,
            "decisions": decisions,
            "dispatched": dispatched,
            "completed": completed,
            "outstanding": out,
            "timings": self.timings(),
            "eval_calls": sum(s.eval_calls
                              for s in self._sessions.values()),
            "count_traces": sum({id(s.engine): s.engine.trace_count
                                 for s in self._sessions.values()}
                                .values()),
            "health": self.health.report(),
            "needs_recalibration": self.health.needs_recalibration(),
        }

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def score(self, item: Any, *, model: Optional[str] = None,
              name: Optional[str] = None) -> Dict[str, float]:
        """Predicted seconds for ``item`` on every machine — the fleet
        price table, zero timings."""
        decision = self.route(item, model=model, name=name, dispatch=False)
        return dict(decision.predicted)

    def route(self, item: Any, *, model: Optional[str] = None,
              name: Optional[str] = None,
              policy: Optional[str] = None,
              dispatch: bool = True) -> RoutingDecision:
        """Price ``item`` on every machine and pick one.  ``dispatch``
        (default) charges the chosen machine's outstanding-load ledger;
        pair it with :meth:`complete` when the work finishes."""
        return self.route_batch(
            [item], model=model,
            names=[name] if name is not None else None,
            policy=policy, dispatch=dispatch)[0]

    def route_batch(self, items: Sequence[Any], *,
                    model: Optional[str] = None,
                    names: Optional[Sequence[str]] = None,
                    policy: Optional[str] = None,
                    dispatch: bool = True) -> List[RoutingDecision]:
        """Route a batch: ONE batched ``predict_batch`` evaluation per
        machine prices every item fleet-wide, then items are placed
        sequentially so each decision sees the load its batch-mates
        already added — a batch of equal jobs spreads across the fleet
        instead of dog-piling the fastest machine."""
        items = list(items)
        if not items:
            return []
        pol = policy if policy is not None else self.policy
        _check_policy(pol)
        per_machine = {m: sess.predict_batch(items, model=model,
                                             names=names)
                       for m, sess in self._sessions.items()}
        # health weights read outside the ledger lock (lock ordering:
        # router ledger and health never nest)
        weights = {m: self.health.weight(m) for m in self._sessions}
        decisions: List[RoutingDecision] = []
        with self._lock:
            for i in range(len(items)):
                predicted = {m: float(per_machine[m][i].seconds)
                             for m in self._sessions}
                kernel = per_machine[next(iter(self._sessions))][i].kernel
                chosen, scores = self._choose(pol, predicted, weights)
                d = RoutingDecision(
                    kernel=kernel, machine=chosen, policy=pol,
                    predicted_s=predicted[chosen], predicted=predicted,
                    scores=scores,
                    outstanding=dict(self._outstanding),
                    weights=dict(weights), seq=self.decisions)
                self.decisions += 1
                if dispatch:
                    self._outstanding[chosen] += predicted[chosen]
                    self._dispatched[chosen] += 1
                decisions.append(d)
        return decisions

    def _choose(self, policy: str, predicted: Dict[str, float],
                weights: Dict[str, float]
                ) -> Tuple[str, Dict[str, float]]:
        """Pick a machine under ``policy``; caller holds the ledger lock.
        Lower score wins; ties resolve to fleet order (deterministic)."""
        names = list(self._sessions)
        if policy == "round_robin":
            chosen = names[self._rr % len(names)]
            self._rr += 1
            return chosen, {}
        if policy == "cheapest":
            scores = {m: predicted[m] / weights[m] for m in names}
        elif policy == "least_loaded":
            scores = {m: self._outstanding[m] / weights[m] for m in names}
        else:   # predicted_makespan
            scores = {m: (self._outstanding[m] + predicted[m]) / weights[m]
                      for m in names}
        chosen = min(names, key=lambda m: (scores[m], names.index(m)))
        return chosen, scores

    # ------------------------------------------------------------------
    # completions (the ledger's other half)
    # ------------------------------------------------------------------

    def complete(self, decision: Union[RoutingDecision, str], *,
                 predicted_s: Optional[float] = None,
                 observed_s: Optional[float] = None) -> None:
        """Mark dispatched work finished: drain its predicted cost from
        the machine's outstanding-load ledger and — when ``observed_s``
        is given — feed the observed-vs-predicted ratio to the health
        tracker (skew EWMA → weight demotion → recalibration flag)."""
        if isinstance(decision, RoutingDecision):
            machine = decision.machine
            if predicted_s is None:
                predicted_s = decision.predicted_s
        else:
            machine = decision
            if predicted_s is None:
                raise ValueError(
                    "complete(machine_name, ...) needs predicted_s= (the "
                    "decision's predicted cost) to drain the ledger")
        with self._lock:
            if machine not in self._outstanding:
                raise KeyError(f"unknown machine {machine!r}; "
                               f"fleet: {self.machines}")
            self._outstanding[machine] = max(
                0.0, self._outstanding[machine] - predicted_s)
            self._completed[machine] += 1
        if observed_s is not None:
            self.health.observe(machine, observed_s=observed_s,
                                predicted_s=predicted_s)

    # ------------------------------------------------------------------
    # recalibration (closing the loop)
    # ------------------------------------------------------------------

    def replace_session(self, machine: str,
                        session: PerfSession) -> None:
        """Swap in a freshly calibrated session for ``machine`` and reset
        its skew state — the last step of the recalibration loop."""
        with self._lock:
            if machine not in self._sessions:
                raise KeyError(f"unknown machine {machine!r}; "
                               f"fleet: {self.machines}")
            self._sessions[machine] = session
        self.health.clear(machine)

    def recalibrate(self, machine: str, source: Any, **open_kw: Any
                    ) -> PerfSession:
        """Recalibrate a flagged machine: run the study against
        ``source`` (a device handle with ``.fingerprint``/``.timer``, or
        ``None`` for this machine's card — ``device="cuda"`` unless
        ``open_kw`` names another; see :meth:`PerfSession.open`),
        swap the fresh session in, and clear the machine's health state.
        This is the only router path that times kernels — and it times
        them through calibration's own counted timer, never the routing
        sessions'.  Do NOT pass a measurement cache warmed before the
        degradation: its entries describe the machine that no longer
        exists."""
        session = PerfSession.open(source, **open_kw)
        fresh = session.profile.fingerprint.id
        if fresh != machine:
            raise ValueError(
                f"recalibration source is machine {fresh!r} but the slot "
                f"being recalibrated is {machine!r} — routing weights "
                f"would be attributed to the wrong hardware")
        self.replace_session(machine, session)
        return session

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset(self, *, policy: Optional[str] = None) -> None:
        """Zero the ledgers, counters, and health state (sessions stay
        hot) — lets one opened fleet run several simulation arms with
        identical starting conditions."""
        if policy is not None:
            _check_policy(policy)
        with self._lock:
            for m in self._sessions:
                self._outstanding[m] = 0.0
                self._dispatched[m] = 0
                self._completed[m] = 0
            self._rr = 0
            self.decisions = 0
            if policy is not None:
                self.policy = policy
        for m in self.machines:
            self.health.clear(m)
        self.health.events.clear()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"available: {list(POLICIES)}")
