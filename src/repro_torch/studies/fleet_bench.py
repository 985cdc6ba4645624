"""Fleet-routing benchmark: decision throughput and makespan quality; the
counterpart of the reference's ``benchmarks/fleet_bench.py``.

**Throughput**: a routing decision is one batched model evaluation per
machine plus ledger arithmetic, with zero kernel timings, so a router
can sit in front of real traffic; this is host time.  **Quality**: on a
heterogeneous 4-device synthetic fleet with a heavy-tailed workload,
predicted-makespan routing is compared against round-robin (the
model-blind baseline) and a greedy clairvoyant oracle (true service
times and queue states) — the derived column reports the fraction of
the oracle gap the predictive policy closes (it can exceed 100%: the
greedy oracle is not a makespan optimum).

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.fleet_bench
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.fleet import FleetRouter, heavy_tailed_jobs, simulate_fleet
from repro_torch.testing.synthdev import exact_profile, synthetic_fleet

N_DEVICES = 4
N_JOBS = 200
ROUTE_REPEATS = 400


def fleet_bench() -> Dict[str, Any]:
    """Seconds per routing decision (warm counts, warm evaluators), the
    timings routing performed (0), and the makespans of round-robin,
    predicted-makespan and the oracle over ``N_JOBS`` jobs."""
    fleet = synthetic_fleet(N_DEVICES)
    devices = {d.fingerprint.id: d for d in fleet}
    profiles = [exact_profile(d) for d in fleet]
    jobs = heavy_tailed_jobs(N_JOBS, seed="fleet-bench",
                             n_machines=N_DEVICES)
    for j in jobs:
        j.kernel.counts()               # counting out of the timed loop

    router = FleetRouter.from_profiles(profiles)

    # decision throughput: route the same mixed stream repeatedly (the
    # steady state of a daemon)
    sample = [j.kernel for j in jobs[:8]]
    router.route_batch(sample, names=[k.name for k in sample])  # warm
    router.reset()
    t0 = time.perf_counter()
    for i in range(ROUTE_REPEATS):
        k = sample[i % len(sample)]
        router.complete(router.route(k, name=k.name))
    per_decision = (time.perf_counter() - t0) / ROUTE_REPEATS
    timings = router.timings()

    router.reset(policy="round_robin")
    rr = simulate_fleet(router, devices, jobs)
    router.reset(policy="predicted_makespan")
    pm = simulate_fleet(router, devices, jobs)
    oracle = simulate_fleet(None, devices, jobs, oracle=True)
    gap = rr.makespan_s - oracle.makespan_s
    return {
        "s_per_decision": per_decision,
        "route_timings": timings,
        "makespan_s": {"round_robin": rr.makespan_s,
                       "predicted_makespan": pm.makespan_s,
                       "oracle": oracle.makespan_s},
        "per_machine_jobs": {
            name: {m: int(v["jobs"]) for m, v in r.per_machine.items()}
            for name, r in (("round_robin", rr), ("predicted_makespan", pm),
                            ("oracle", oracle))},
        "speedup_vs_rr": rr.makespan_s / pm.makespan_s,
        "oracle_gap_closed": ((rr.makespan_s - pm.makespan_s) / gap
                              if gap > 0 else 1.0),
        "sim_timings": rr.routing_timings + pm.routing_timings,
    }


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a :func:`fleet_bench`
    result."""
    r, ms = result, result["makespan_s"]
    return [
        f"fleet.route_us_per_decision,{r['s_per_decision'] * 1e6:.2f},"
        f"{1.0 / r['s_per_decision']:.0f}_decisions_per_s",
        f"fleet.route_timings,{r['route_timings']},zero_required",
        f"fleet.makespan_round_robin_us,{ms['round_robin'] * 1e6:.2f},",
        f"fleet.makespan_predicted_us,"
        f"{ms['predicted_makespan'] * 1e6:.2f},"
        f"{r['speedup_vs_rr']:.2f}x_vs_rr",
        f"fleet.makespan_oracle_us,{ms['oracle'] * 1e6:.2f},"
        f"{r['oracle_gap_closed'] * 100:.0f}%_of_oracle_gap_closed",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.studies.fleet_bench",
        description="Routing decision throughput and makespan against "
                    "round-robin and the oracle on a synthetic 4-device "
                    "fleet; prints CSV rows (name,us_per_call,derived)."
    ).parse_args(argv)
    print("name,us_per_call,derived")
    for row in rows(fleet_bench()):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
