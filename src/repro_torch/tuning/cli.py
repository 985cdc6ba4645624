"""``python -m repro_torch.tune`` — the predictor-guided autotuner CLI,
the counterpart of ``repro.tuning.cli``.

Search the §8 variant spaces (or a custom tag template) with a
calibrated profile, time only the pruned survivors on ``--device``
(``cuda`` unless asked otherwise), and persist winners back into the
profile::

  # calibrate a synthetic machine + tune all three §8 spaces, save winners
  python -m repro_torch.tune search --synthetic citra --smoke --trials 2 \\
      --cache-dir .tune-cache --profile tune_profile.json --save \\
      --verify-optimum --max-timed-fraction 0.2

  # warm re-tune: every space is already recorded — MUST be pure cache
  python -m repro_torch.tune search --synthetic citra --trials 2 \\
      --cache-dir .tune-cache --profile tune_profile.json \\
      --expect-zero-timings

  # tune on the card from a calibrated profile
  python -m repro_torch.tune search --profile h100.json --model base \\
      --margin 0 --save

  # inspect recorded winners
  python -m repro_torch.tune report tune_profile.json

Every claim is exit-coded: ``--verify-optimum`` (the winner must be
ground-truth optimal on a synthetic device), ``--max-timed-fraction``
(the confirmation budget), and ``--expect-zero-timings`` (a warm re-tune
performs zero timings, zero counting passes, zero batched evaluations).
A ``--synthetic`` device needs no card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.tuning.space import (
    SECTION8_SPACE_TAGS,
    TuningSpace,
    enumerate_space,
)
from repro_torch.tuning.tuner import (
    TuneResult,
    exhaustive_search,
    true_optimal_set,
    tune_space,
)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Predictor-guided variant autotuning over a "
                    "calibrated machine profile.")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser(
        "search",
        help="price a variant space in one batched evaluation, time "
             "only the pruned top-k, record the winner")
    s.add_argument("--profile", type=Path, default=None,
                   help="profile artifact to load (and, with --save, "
                        "write winners back to); missing file triggers "
                        "on-demand calibration")
    s.add_argument("--synthetic", metavar="NAME", default=None,
                   help="tune a synthetic ground-truth device "
                        "(apex/bulk/citra) instead of this machine")
    s.add_argument("--synthetic-noise", type=float, default=0.0,
                   help="relative timing noise of the synthetic device")
    s.add_argument("--device", default="cuda",
                   help="device to calibrate and time on (default cuda; "
                        "ignored with --synthetic)")
    s.add_argument("--smoke", action="store_true",
                   help="calibrate (when needed) on the fast smoke "
                        "battery instead of the full study tags")
    s.add_argument("--space", action="append", default=None,
                   metavar="NAME",
                   help="which built-in §8 space(s) to search "
                        f"({', '.join(n for n, _ in SECTION8_SPACE_TAGS)}); "
                        "repeatable; default: all")
    s.add_argument("--tags", nargs="+", default=None,
                   help="custom space: tag templates, e.g. matmul_sq "
                        "n:768 'tile:{16,32,64,128}' "
                        "'prefetch:{True,False}'")
    s.add_argument("--model", default=None,
                   help="fit name to price with (default: the profile's "
                        "default model)")
    s.add_argument("--trials", type=int, default=None,
                   help="trials per confirmation timing (default: the "
                        "profile's calibration trials)")
    s.add_argument("--cache-dir", type=Path, default=None,
                   help="measurement cache directory (shared with "
                        "calibration)")
    s.add_argument("--top-fraction", type=float, default=0.2,
                   help="fraction of the space to confirm (default 0.2)")
    s.add_argument("--top-k", type=int, default=None,
                   help="absolute survivor count (overrides "
                        "--top-fraction)")
    s.add_argument("--margin", type=float, default=None,
                   help="near-tie prune margin (default: derived from "
                        "the fit's held-out gmre)")
    s.add_argument("--force", action="store_true",
                   help="re-search spaces that already have a recorded "
                        "winner")
    s.add_argument("--save", action="store_true",
                   help="persist the profile (with its tuning section) "
                        "back to --profile")
    s.add_argument("--exhaustive", action="store_true",
                   help="also time EVERY variant as a baseline and "
                        "report the pruned search's savings")
    s.add_argument("--verify-optimum", action="store_true",
                   help="exit nonzero unless each winner is ground-truth "
                        "optimal (synthetic devices only)")
    s.add_argument("--max-timed-fraction", type=float, default=None,
                   metavar="F",
                   help="exit nonzero if a cold search confirmed more "
                        "than max(1, ceil(F * n_variants)) variants")
    s.add_argument("--expect-zero-timings", action="store_true",
                   help="exit nonzero unless the whole run performed 0 "
                        "kernel timings, 0 counting passes, and 0 batched "
                        "evaluations (the warm re-tune guarantee)")
    s.add_argument("--json", type=Path, default=None,
                   help="write the machine-readable search report here")

    r = sub.add_parser("report",
                       help="print a profile's recorded tuning winners")
    r.add_argument("profile", type=Path)
    r.add_argument("--json", type=Path, default=None)
    return p


def _open_session(args) -> "Any":
    from repro_torch.api.session import PerfSession

    device = None
    if args.synthetic:
        from repro_torch.testing.synthdev import fleet_device
        device = fleet_device(args.synthetic, noise=args.synthetic_noise)
        timer = device.timer
    else:
        import functools

        from repro_torch.core.uipick import default_timer
        from repro_torch.device import resolve_device
        timer = functools.partial(default_timer,
                                  device=resolve_device(args.device))
    if args.profile is not None and args.profile.exists():
        return PerfSession.open(args.profile, cache=args.cache_dir,
                                timer=timer), device
    tags = None
    if args.smoke:
        from repro_torch.studies.zoo import STUDY_SMOKE_TAGS
        tags = STUDY_SMOKE_TAGS
    session = PerfSession.open(
        device, tags=tags, trials=args.trials or 8, cache=args.cache_dir,
        timer=timer, device=args.device,
        save_to=args.profile if args.save else None)
    return session, device


def _spaces_for(args) -> List[TuningSpace]:
    if args.tags is not None:
        return [enumerate_space("custom", args.tags)]
    builtin = dict(SECTION8_SPACE_TAGS)
    wanted = args.space or [n for n, _ in SECTION8_SPACE_TAGS]
    unknown = [n for n in wanted if n not in builtin]
    if unknown:
        raise SystemExit(f"unknown space(s) {unknown}; "
                         f"available: {sorted(builtin)}")
    return [enumerate_space(n, builtin[n]) for n in wanted]


def _budget_of(fraction: float, n_variants: int) -> int:
    # a search that confirms nothing confirms the model, not the winner:
    # every space is granted at least one timing
    return max(1, math.ceil(fraction * n_variants))


def _result_payload(space: TuningSpace, res: TuneResult) -> Dict[str, Any]:
    c = res.choice
    return {
        "space": space.name, "signature": space.signature,
        "n_variants": c.n_variants, "warm": res.warm,
        "winner": c.winner, "model": c.model,
        "predicted_s": c.predicted_s, "measured_s": c.measured_s,
        "n_timed": c.n_timed, "timings_performed": res.timings_performed,
        "margin": c.margin, "survivors": res.survivors,
        "predicted": c.predicted, "measured": c.measured,
        "wall_s": res.wall_s,
    }


def _cmd_search(args) -> int:
    failures: List[str] = []
    session, device = _open_session(args)
    spaces = _spaces_for(args)
    payloads: List[Dict[str, Any]] = []
    for space in spaces:
        res = tune_space(session, space, model=args.model,
                         top_fraction=args.top_fraction,
                         top_k=args.top_k, margin=args.margin,
                         trials=args.trials, force=args.force)
        c = res.choice
        mode = "warm (recorded winner, pure cache)" if res.warm \
            else f"cold ({res.timings_performed} timing passes)"
        print(f"== space {space.name}: {len(space)} variants, {mode}")
        if not res.warm:
            for name, pred in sorted(c.predicted.items(),
                                     key=lambda kv: kv[1]):
                marker = " *" if name in c.measured else ""
                meas = (f"  meas {c.measured[name] * 1e6:10.2f} us"
                        if name in c.measured else "")
                print(f"   pred {pred * 1e6:10.2f} us{meas}"
                      f"   {name}{marker}")
        print(f"   winner: {c.winner}  "
              f"(pred {c.predicted_s * 1e6:.2f} us, "
              f"meas {c.measured_s * 1e6:.2f} us; "
              f"timed {c.n_timed}/{c.n_variants})")

        if args.max_timed_fraction is not None and not res.warm:
            budget = _budget_of(args.max_timed_fraction, c.n_variants)
            if c.n_timed > budget:
                failures.append(
                    f"space {space.name}: confirmed {c.n_timed} variants, "
                    f"budget is {budget} "
                    f"(max(1, ceil({args.max_timed_fraction} * "
                    f"{c.n_variants})))")
        if args.verify_optimum:
            if device is None:
                failures.append(
                    "--verify-optimum needs --synthetic (ground truth is "
                    "only known for synthetic devices)")
            else:
                optimal = true_optimal_set(device, space)
                if c.winner in optimal:
                    print(f"   optimum verified: {c.winner} in {optimal}")
                else:
                    failures.append(
                        f"space {space.name}: winner {c.winner!r} is not "
                        f"ground-truth optimal ({optimal})")
        payload = _result_payload(space, res)
        if args.exhaustive:
            ex_winner, ex_measured, ex_timings = exhaustive_search(
                session, space, trials=args.trials)
            saved = ex_timings - res.timings_performed
            print(f"   exhaustive baseline: {ex_timings} timing passes "
                  f"(pruned saved {saved}); winner {ex_winner}")
            payload["exhaustive"] = {
                "winner": ex_winner, "timings_performed": ex_timings,
                "measured": ex_measured,
            }
        payloads.append(payload)

    if args.save:
        if args.profile is None:
            failures.append("--save needs --profile PATH")
        else:
            from repro_torch.profiles.profile import save_profile
            save_profile(session.profile, args.profile)
            print(f"profile (with {len(session.profile.tuning)} tuned "
                  f"space(s)) saved to {args.profile}")

    timings = session.timer.calls
    traces = session.engine.trace_count
    evals = session.eval_calls
    print(f"totals: {timings} timing passes, {traces} count traces, "
          f"{evals} batched evaluations")
    if args.expect_zero_timings and (timings or traces or evals):
        failures.append(
            f"expected a pure-cache run but performed {timings} "
            f"timings, {traces} counting passes, {evals} batched "
            f"evaluations")

    if args.json is not None:
        args.json.write_text(json.dumps({
            "spaces": payloads,
            "totals": {"timings": timings, "traces": traces,
                       "eval_calls": evals},
        }, indent=2, sort_keys=True) + "\n")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


def _cmd_report(args) -> int:
    from repro_torch.profiles.profile import load_profile

    profile = load_profile(args.profile)
    if not profile.tuning:
        print(f"profile {args.profile} records no tuned spaces")
        return 0
    print(f"profile {profile.fingerprint.id}: "
          f"{len(profile.tuning)} tuned space(s)")
    for sig, c in sorted(profile.tuning.items(),
                         key=lambda kv: kv[1].space_name):
        print(f"== {c.space_name}  [{sig[:12]}…]")
        print(f"   winner {c.winner}  model {c.model}")
        print(f"   pred {c.predicted_s * 1e6:.2f} us  "
              f"meas {c.measured_s * 1e6:.2f} us  "
              f"timed {c.n_timed}/{c.n_variants} "
              f"({c.timings_spent} passes paid, trials {c.trials}, "
              f"margin {c.margin:.3f})")
    if args.json is not None:
        args.json.write_text(json.dumps(
            {sig: c.to_dict() for sig, c in profile.tuning.items()},
            indent=2, sort_keys=True) + "\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "search":
        return _cmd_search(args)
    return _cmd_report(args)


if __name__ == "__main__":
    sys.exit(main())
