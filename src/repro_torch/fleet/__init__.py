"""``repro_torch.fleet`` — predictive routing across a fleet of machine
profiles; the counterpart of ``repro.fleet``.

The paper's first motivating use case for cheap cross-machine models:

* :class:`FleetRouter` — open N machine profiles, price every incoming
  workload on all of them via ``predict_batch`` (zero timings, one
  batched evaluation per machine), and route by predicted completion
  time: predicted cost plus an outstanding-load ledger, divided by a
  health weight.  Policies: ``round_robin`` (the model-blind baseline),
  ``cheapest``, ``least_loaded``, ``predicted_makespan`` (default).
* :class:`FleetHealth` — per-machine EWMA of observed-vs-predicted
  runtime skew.  Drifted machines get their routing weight demoted and,
  past a threshold, a latched recalibration flag.
* :func:`simulate_fleet` / :func:`heavy_tailed_jobs` — a deterministic
  discrete-event simulator over synthetic ground-truth fleets
  (:mod:`repro_torch.testing.synthdev`), so "predictive routing beats
  round-robin" and "health demotion recovers a degraded fleet's
  makespan" are hard gates on the host in seconds.

CLI: ``python -m repro_torch.fleet`` (``route`` / ``simulate`` /
``health``).  The serving daemon mounts the same router at
``POST /route`` / ``GET /fleet`` / ``POST /complete``.

Thread safety follows :mod:`repro_torch.api`: prediction through each
machine's session is thread-safe (a locked ``PredictEngine`` and a count
engine that serializes internally, one engine shared across the fleet
so a workload is counted once, not N times); :class:`FleetHealth`
serializes its skew ledger; the router guards its outstanding-load
ledger and round-robin cursor with one lock, taken after predictions and
never while holding the health lock.  Construction and
``replace_session``/``recalibrate`` follow the single-writer convention
of session open/calibrate.
"""
from repro_torch.fleet.health import FleetHealth, HealthEvent, MachineHealth
from repro_torch.fleet.router import (
    DEFAULT_POLICY,
    POLICIES,
    FleetRouter,
    RoutingDecision,
)
from repro_torch.fleet.sim import (
    Degradation,
    Job,
    SimReport,
    heavy_tailed_jobs,
    simulate_fleet,
)

__all__ = [
    "DEFAULT_POLICY",
    "POLICIES",
    "Degradation",
    "FleetHealth",
    "FleetRouter",
    "HealthEvent",
    "Job",
    "MachineHealth",
    "RoutingDecision",
    "SimReport",
    "heavy_tailed_jobs",
    "simulate_fleet",
]
