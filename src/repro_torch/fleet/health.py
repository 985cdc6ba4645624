"""Fleet health: observed-vs-predicted skew → weight demotion →
recalibration; the counterpart of ``repro.fleet.health``.

:class:`FleetHealth` tracks, for every machine of a routed fleet, the
ratio of observed to model-predicted runtime as an EWMA — the *skew*.  A
healthy, well-calibrated machine sits at skew ≈ 1.  A machine running
consistently slower than its profile predicts (thermal throttling, a
sick memory stack, a noisy neighbour) drifts above 1, and:

* past ``demote_skew`` its **routing weight** drops to ``1 / skew``
  (floored at ``min_weight``) — the router divides effective completion
  times by this weight, so predicted-makespan routing sends the machine
  proportionally less work;
* past ``recalibrate_skew`` the machine is **flagged for recalibration**
  (latched until :meth:`clear`), the ``on_recalibrate`` callback fires
  once, and the event carries the ``python -m repro_torch.calibrate``
  hint that closes the loop.

Everything here is observed-time bookkeeping: this module times no
kernel; observations arrive from whoever ran the work (the fleet
simulator, a ``POST /complete`` against the serving daemon, a card's own
measured times).  All methods are thread-safe.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

__all__ = ["FleetHealth", "HealthEvent", "MachineHealth"]


@dataclass(frozen=True)
class HealthEvent:
    """One machine crossing the recalibration threshold."""

    machine: str
    skew: float                 # EWMA of observed / predicted at flag time
    n_obs: int
    hint: str = ""              # the CLI command that closes the loop

    @staticmethod
    def recalibrate_hint(machine: str) -> str:
        return (f"machine {machine!r}: observed runtimes have drifted from "
                f"its profile — recalibrate with `python -m "
                f"repro_torch.calibrate --zoo --out <profile.json>` on "
                f"that machine and reload")


@dataclass
class MachineHealth:
    """One machine's skew state (a value snapshot — safe to hand out)."""

    machine: str
    skew: float = 1.0           # EWMA of observed / predicted runtime
    n_obs: int = 0
    flagged: bool = False       # recalibration latch

    @property
    def degradation(self) -> float:
        """How much slower than predicted the machine runs (0 = healthy)."""
        return max(0.0, self.skew - 1.0)


class FleetHealth:
    """Observed-vs-predicted skew ledger for a routed fleet.

    ``alpha`` is the EWMA step; ``min_obs`` observations are required
    before any demotion or flagging (a single noisy completion must not
    demote a machine); ``demote_skew`` is where weight demotion starts;
    ``recalibrate_skew`` is where the latched recalibration flag (and the
    ``on_recalibrate`` callback) fires; ``min_weight`` floors demotion so
    a degraded machine still drains SOME work (``min_weight=1.0``
    disables demotion entirely while keeping skew tracking and flags —
    the simulator's control arm).
    """

    def __init__(self, *, alpha: float = 0.25, min_obs: int = 3,
                 demote_skew: float = 1.25,
                 recalibrate_skew: float = 2.0,
                 min_weight: float = 0.05,
                 on_recalibrate: Optional[Callable[[HealthEvent], None]]
                 = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 < min_weight <= 1.0:
            raise ValueError(
                f"min_weight must be in (0, 1], got {min_weight}")
        if recalibrate_skew < demote_skew:
            raise ValueError(
                f"recalibrate_skew ({recalibrate_skew}) below demote_skew "
                f"({demote_skew}): a machine would be flagged for "
                f"recalibration before its weight ever moved")
        self.alpha = float(alpha)
        self.min_obs = int(min_obs)
        self.demote_skew = float(demote_skew)
        self.recalibrate_skew = float(recalibrate_skew)
        self.min_weight = float(min_weight)
        self.on_recalibrate = on_recalibrate
        self.events: List[HealthEvent] = []
        self._lock = threading.Lock()
        self._machines: Dict[str, MachineHealth] = {}

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def observe(self, machine: str, *, observed_s: float,
                predicted_s: float) -> MachineHealth:
        """Fold one completed work item into ``machine``'s skew EWMA.
        Returns a snapshot of the updated state."""
        if not predicted_s > 0.0:
            raise ValueError(
                f"predicted_s must be positive, got {predicted_s!r} "
                f"(a zero prediction would make every skew infinite)")
        if not observed_s >= 0.0:
            raise ValueError(f"observed_s must be >= 0, got {observed_s!r}")
        ratio = observed_s / predicted_s
        fire: Optional[HealthEvent] = None
        with self._lock:
            h = self._machines.get(machine)
            if h is None:
                h = MachineHealth(machine=machine)
                self._machines[machine] = h
            h.skew = ratio if h.n_obs == 0 \
                else (1.0 - self.alpha) * h.skew + self.alpha * ratio
            h.n_obs += 1
            if not h.flagged and h.n_obs >= self.min_obs \
                    and h.skew >= self.recalibrate_skew:
                h.flagged = True
                fire = HealthEvent(
                    machine=machine, skew=h.skew, n_obs=h.n_obs,
                    hint=HealthEvent.recalibrate_hint(machine))
                self.events.append(fire)
            snap = replace(h)
        if fire is not None and self.on_recalibrate is not None:
            self.on_recalibrate(fire)
        return snap

    # ------------------------------------------------------------------
    # routing-side reads
    # ------------------------------------------------------------------

    def weight(self, machine: str) -> float:
        """The machine's routing weight in (0, 1]: 1 while healthy (or
        under-observed), ``1 / skew`` once demotion starts, floored at
        ``min_weight``.  Routers DIVIDE effective completion times by
        this, so weight 0.25 reads "this machine currently runs 4× its
        predictions"."""
        with self._lock:
            h = self._machines.get(machine)
            if h is None or h.n_obs < self.min_obs \
                    or h.skew <= self.demote_skew:
                return 1.0
            return min(1.0, max(self.min_weight, 1.0 / h.skew))

    def skew(self, machine: str) -> float:
        with self._lock:
            h = self._machines.get(machine)
            return 1.0 if h is None else h.skew

    def state(self, machine: str) -> MachineHealth:
        with self._lock:
            h = self._machines.get(machine)
            return MachineHealth(machine=machine) if h is None \
                else replace(h)

    def needs_recalibration(self) -> List[str]:
        """Machines whose latched recalibration flag is up, sorted."""
        with self._lock:
            return sorted(m for m, h in self._machines.items() if h.flagged)

    # ------------------------------------------------------------------
    # closing the loop
    # ------------------------------------------------------------------

    def clear(self, machine: str) -> None:
        """Forget a machine's skew state — call after recalibrating it
        (its fresh profile resets the observed-vs-predicted baseline)."""
        with self._lock:
            self._machines.pop(machine, None)

    def report(self) -> Dict[str, Dict[str, float]]:
        """Deterministic per-machine health table (JSON-ready)."""
        with self._lock:
            machines = {m: replace(h)
                        for m, h in sorted(self._machines.items())}
        return {m: {"skew": h.skew, "n_obs": h.n_obs,
                    "degradation": h.degradation,
                    "weight": self.weight(m),
                    "flagged": h.flagged}
                for m, h in machines.items()}
