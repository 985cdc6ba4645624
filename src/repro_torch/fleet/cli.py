"""``python -m repro_torch.fleet`` — predictive fleet routing from the
shell; the counterpart of ``repro.fleet.cli``.

Three subcommands:

``route PROFILES... --kernel NAME``
    Open the profiles (zero measurements, one shared count engine),
    price the named built-in kernel target on every machine, and print
    the fleet price table plus the routing decision.

``simulate --synthetic N --policy predicted_makespan``
    Build an ``N``-device heterogeneous synthetic fleet, stream a
    deterministic heavy-tailed workload through a round-robin baseline
    and the requested policy, and turn the claims into an exit code: the
    predictive policy's makespan must not exceed round-robin's, the
    same scenario replayed must give an identical report, and — with
    ``--expect-zero-timings`` — routing must never time a kernel.

``health --synthetic N --degrade-factor 4``
    One machine silently runs slower than its profile; a control arm
    (demotion disabled) and a health arm (demotion enabled) run the same
    stream, and the exit code asserts the health layer flags the
    machine, demotes its routing weight and recovers makespan.
    ``--recalibrate`` re-studies the flagged machine against its degraded
    truth (fresh measurements through the synthetic device's own timer,
    no stale cache) and swaps the new session in mid-run.

Every synthetic device times through its own timer, so none of the
three needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.health import FleetHealth
from repro_torch.fleet.router import DEFAULT_POLICY, POLICIES, FleetRouter
from repro_torch.fleet.sim import (
    Degradation,
    heavy_tailed_jobs,
    simulate_fleet,
)
from repro_torch.testing.synthdev import (
    SyntheticDevice,
    exact_profile,
    synthetic_fleet,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Model-guided routing across a fleet of calibrated "
                    "machine profiles: price each workload everywhere "
                    "(zero timings), route by predicted completion time.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rt = sub.add_parser(
        "route", help="price a built-in kernel target across profiles "
                      "and print the routing decision")
    rt.add_argument("profiles", nargs="+",
                    help="calibrated machine-profile JSON files")
    rt.add_argument("--kernel", required=True,
                    help="built-in kernel target name "
                         "(see `python -m repro_torch.lint --list`)")
    rt.add_argument("--policy", default=DEFAULT_POLICY, choices=POLICIES)
    rt.add_argument("--model", default=None,
                    help="zoo fit to predict with (default: best in "
                         "profile)")
    rt.add_argument("--cache-dir", default=None,
                    help="measurement-cache directory (persistent count "
                         "store shared by the whole fleet)")
    rt.add_argument("--repeat", type=int, default=1,
                    help="dispatch the kernel this many times (the "
                         "ledger makes later copies spread)")

    sim = sub.add_parser(
        "simulate", help="synthetic-fleet scheduling simulation: "
                         "predictive policy vs round-robin, as an exit "
                         "code")
    _fleet_args(sim)
    sim.add_argument("--policy", default=DEFAULT_POLICY, choices=POLICIES)
    sim.add_argument("--jobs", type=int, default=120,
                     help="jobs in the heavy-tailed arrival stream")
    sim.add_argument("--degrade", action="append", default=[],
                     metavar="DEV:FACTOR[@T]",
                     help="degrade a device mid-run, e.g. apex:4@0.01 "
                          "(repeatable)")
    sim.add_argument("--json", default=None,
                     help="write the per-policy reports to this file")
    sim.add_argument("--expect-zero-timings", action="store_true",
                     help="exit 1 if routing timed ANY kernel")

    hl = sub.add_parser(
        "health", help="degraded-device scenario: skew flags "
                       "recalibration, weight demotion recovers makespan")
    _fleet_args(hl)
    hl.add_argument("--degrade-factor", type=float, default=4.0,
                    help="how much slower the sick machine runs than its "
                         "profile predicts")
    hl.add_argument("--device", default=None,
                    help="which device gets sick (default: the machine "
                         "predictive routing leans on hardest — the "
                         "worst case)")
    hl.add_argument("--degrade-after", type=float, default=0.0,
                    help="simulation time at which the degradation sets in")
    hl.add_argument("--jobs", type=int, default=96)
    hl.add_argument("--recalibrate", action="store_true",
                    help="close the loop: re-study the flagged machine "
                         "against its degraded truth and swap the fresh "
                         "session in mid-run")
    hl.add_argument("--json", default=None)
    return ap


def _fleet_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--synthetic", type=int, required=True, metavar="N",
                   help="number of synthetic ground-truth devices")
    p.add_argument("--noise", type=float, default=0.0,
                   help="relative timing noise of the synthetic devices")
    p.add_argument("--calibrate", action="store_true",
                   help="calibrate each device with a real (smoke-sized) "
                        "study instead of using exact truth profiles")
    p.add_argument("--trials", type=int, default=3,
                   help="timing trials per kernel when --calibrate")
    p.add_argument("--seed", default="fleet-sim",
                   help="workload stream seed (any string)")
    p.add_argument("--tail", type=float, default=2.5,
                   help="heavy-tail exponent of the job-cost mix")


# ---------------------------------------------------------------------------
# fleet construction
# ---------------------------------------------------------------------------

def _build_fleet(args) -> Tuple[Dict[str, SyntheticDevice], List]:
    """(fingerprint-id → device, profiles) for an ``--synthetic N``
    fleet.  Exact truth profiles by default (placement quality in
    isolation); ``--calibrate`` runs the real smoke study per device —
    through each device's injectable timer, not this machine's clock."""
    fleet = synthetic_fleet(args.synthetic, noise=args.noise)
    devices = {d.fingerprint.id: d for d in fleet}
    if not args.calibrate:
        return devices, [exact_profile(d) for d in fleet]
    from repro_torch.api import PerfSession
    from repro_torch.studies.zoo import STUDY_SMOKE_TAGS
    profiles = []
    for d in fleet:
        session = PerfSession.open(d, tags=STUDY_SMOKE_TAGS,
                                   trials=args.trials)
        profiles.append(session.profile)
    return devices, profiles


def _resolve_machine(name: str, devices: Dict[str, SyntheticDevice]) -> str:
    """Accept either a fingerprint id or the short device name."""
    if name in devices:
        return name
    for fid, d in devices.items():
        if d.name == name:
            return fid
    raise SystemExit(f"unknown device {name!r}; fleet: "
                     f"{sorted(d.name for d in devices.values())}")


def _parse_degrade(specs: Sequence[str],
                   devices: Dict[str, SyntheticDevice]
                   ) -> List[Degradation]:
    out = []
    for spec in specs:
        try:
            dev, rest = spec.split(":", 1)
            after = 0.0
            if "@" in rest:
                rest, after_s = rest.split("@", 1)
                after = float(after_s)
            out.append(Degradation(machine=_resolve_machine(dev, devices),
                                   factor=float(rest), after_s=after))
        except ValueError as e:
            raise SystemExit(
                f"bad --degrade spec {spec!r} (want DEV:FACTOR[@T]): {e}")
    return out


def _short(machine_id: str, devices: Dict[str, SyntheticDevice]) -> str:
    d = devices.get(machine_id)
    return d.name if d is not None else machine_id


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------

def run_route(args) -> int:
    from repro_torch.analysis.targets import kernel_targets

    targets = {t.name: t for t in kernel_targets()}
    if args.kernel not in targets:
        print(f"unknown kernel target {args.kernel!r}; known: "
              f"{', '.join(sorted(targets))}", file=sys.stderr)
        return 2
    t = targets[args.kernel]
    router = FleetRouter.open(args.profiles, cache=args.cache_dir,
                              policy=args.policy)
    try:
        decisions = router.route_batch(
            [(t.fn, t.args)] * max(1, args.repeat),
            names=[t.name] * max(1, args.repeat), model=args.model)
        first = decisions[0]
        print(f"fleet of {len(router.machines)} machine(s), "
              f"policy {args.policy}:")
        for m in router.machines:
            mark = " <- routed" if m == first.machine else ""
            print(f"  {m:40s} predicted {first.predicted[m]:.3e} s"
                  f"{mark}")
        if len(decisions) > 1:
            placed: Dict[str, int] = {}
            for d in decisions:
                placed[d.machine] = placed.get(d.machine, 0) + 1
            spread = ", ".join(f"{m}×{n}"
                               for m, n in sorted(placed.items()))
            print(f"  {args.repeat} copies spread: {spread}")
        print(f"  routing timings: {router.timings()} "
              f"(predictions only)")
    finally:
        router.close()
    return 0


# ---------------------------------------------------------------------------
# simulate (the CI gate)
# ---------------------------------------------------------------------------

def run_simulate(args) -> int:
    devices, profiles = _build_fleet(args)
    degradations = _parse_degrade(args.degrade, devices)
    jobs = heavy_tailed_jobs(args.jobs, seed=args.seed, tail=args.tail,
                             n_machines=len(devices))
    router = FleetRouter.from_profiles(profiles, policy="round_robin")
    failures: List[str] = []
    reports = {}

    baseline = simulate_fleet(router, devices, jobs,
                              degradations=degradations)
    reports["round_robin"] = baseline.to_dict()

    router.reset(policy=args.policy)
    report = simulate_fleet(router, devices, jobs,
                            degradations=degradations)
    reports[args.policy] = report.to_dict()

    # bit-determinism: the same scenario replayed must be byte-identical
    router.reset(policy=args.policy)
    replay = simulate_fleet(router, devices, jobs,
                            degradations=degradations)
    if json.dumps(replay.to_dict(), sort_keys=True) != \
            json.dumps(report.to_dict(), sort_keys=True):
        failures.append("simulation is not bit-deterministic: replaying "
                        "the same scenario produced a different report")

    for name in ("round_robin", args.policy):
        r = reports[name]
        spread = ", ".join(
            f"{_short(m, devices)}:{int(v['jobs'])}"
            for m, v in sorted(r["per_machine"].items()))
        print(f"fleet sim [{name:18s}] {r['n_jobs']} jobs  "
              f"makespan {r['makespan_s']:.4e} s  ({spread})")

    if args.policy != "round_robin":
        if report.makespan_s > baseline.makespan_s:
            failures.append(
                f"predictive policy {args.policy!r} LOST to round-robin: "
                f"{report.makespan_s:.4e} s vs "
                f"{baseline.makespan_s:.4e} s")
        else:
            win = baseline.makespan_s / max(report.makespan_s, 1e-30)
            print(f"fleet sim: {args.policy} beats round_robin "
                  f"{win:.2f}x on makespan")
    if args.expect_zero_timings and router.timings() != 0:
        failures.append(f"routing timed a kernel "
                        f"({router.timings()} timer calls)")
    else:
        print(f"fleet sim: routing timings {router.timings()}, "
              f"{report.decisions + baseline.decisions + replay.decisions} "
              f"decisions")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=2, sort_keys=True)
        print(f"fleet sim: reports written to {args.json}")

    if failures:
        for f in failures:
            print(f"fleet sim FAILED: {f}", file=sys.stderr)
        return 1
    print("fleet sim OK")
    return 0


# ---------------------------------------------------------------------------
# health (the degraded-device scenario)
# ---------------------------------------------------------------------------

def run_health(args) -> int:
    devices, profiles = _build_fleet(args)
    jobs = heavy_tailed_jobs(args.jobs, seed=args.seed, tail=args.tail,
                             n_machines=len(devices))
    if args.device is not None:
        sick = _resolve_machine(args.device, devices)
    else:
        # the worst case: the machine predictive routing leans on hardest
        # goes bad — found with a deterministic undegraded probe run
        probe_router = FleetRouter.from_profiles(profiles,
                                                 policy=DEFAULT_POLICY)
        probe = simulate_fleet(probe_router, devices, jobs)
        sick = max(sorted(probe.per_machine),
                   key=lambda m: probe.per_machine[m]["jobs"])
    degradations = [Degradation(machine=sick, factor=args.degrade_factor,
                                after_s=args.degrade_after)]
    failures: List[str] = []

    # control arm: demotion disabled (min_weight=1.0 keeps every weight
    # at 1), skew tracking and flags still live
    control_router = FleetRouter.from_profiles(
        profiles, policy=DEFAULT_POLICY,
        health=FleetHealth(min_weight=1.0))
    control = simulate_fleet(control_router, devices, jobs,
                             degradations=degradations)

    # health arm: demotion enabled (defaults), optionally closing the
    # recalibration loop with a real re-study of the degraded machine
    recalibrate_fn = None
    if args.recalibrate:
        from repro_torch.api import PerfSession
        from repro_torch.studies.zoo import STUDY_SMOKE_TAGS

        def recalibrate_fn(machine: str):
            # the machine's measurement cache predates the degradation —
            # recalibrate from fresh timings only (cache=None)
            degraded_truth = devices[machine].degraded(args.degrade_factor)
            return PerfSession.open(degraded_truth, cache=None,
                                    tags=STUDY_SMOKE_TAGS,
                                    trials=args.trials)

    router = FleetRouter.from_profiles(profiles, policy=DEFAULT_POLICY)
    report = simulate_fleet(router, devices, jobs,
                            degradations=degradations,
                            recalibrate_fn=recalibrate_fn)

    short = _short(sick, devices)
    print(f"fleet health: {short} degraded {args.degrade_factor:g}x "
          f"after t={args.degrade_after:g}s over {args.jobs} jobs")
    print(f"  control (no demotion): makespan {control.makespan_s:.4e} s, "
          f"flagged {[_short(m, devices) for m in control.recalibration_flagged]}")
    print(f"  health  (demotion):    makespan {report.makespan_s:.4e} s, "
          f"flagged {[_short(m, devices) for m in report.recalibration_flagged]}, "
          f"weights {{" +
          ", ".join(f"{_short(m, devices)}: {w:.3g}"
                    for m, w in sorted(report.weights.items())) + "}")

    if sick not in report.recalibration_flagged and not report.recalibrated:
        failures.append(f"degraded machine {short!r} was never flagged "
                        f"for recalibration")
    if not args.recalibrate and report.weights.get(sick, 1.0) >= 1.0:
        failures.append(f"degraded machine {short!r} kept routing "
                        f"weight 1.0 — demotion never engaged")
    if report.makespan_s > control.makespan_s:
        failures.append(
            f"health demotion did not recover makespan: "
            f"{report.makespan_s:.4e} s (demoted) vs "
            f"{control.makespan_s:.4e} s (control)")
    else:
        win = control.makespan_s / max(report.makespan_s, 1e-30)
        print(f"  demotion recovers {win:.2f}x makespan vs control")
    if args.recalibrate:
        if sick not in report.recalibrated:
            failures.append(f"--recalibrate: flagged machine {short!r} "
                            f"was never recalibrated")
        else:
            print(f"  recalibrated mid-run: "
                  f"{[_short(m, devices) for m in report.recalibrated]}")
    if router.timings() != 0 and not args.recalibrate:
        failures.append(f"routing timed a kernel "
                        f"({router.timings()} timer calls)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"control": control.to_dict(),
                       "health": report.to_dict()},
                      f, indent=2, sort_keys=True)

    if failures:
        for f in failures:
            print(f"fleet health FAILED: {f}", file=sys.stderr)
        return 1
    print("fleet health OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "route":
        return run_route(args)
    if args.cmd == "simulate":
        return run_simulate(args)
    return run_health(args)


if __name__ == "__main__":
    raise SystemExit(main())
