"""Predictor-guided autotuning against exhaustive timing — the §4
pruning claim on the card; the counterpart of the reference's
``benchmarks/autotune_bench.py``.

Searches the three §8 variant spaces with a profile's ``base`` fit: the
pruned search prices every variant in one batched evaluation and times
only the top-k survivors (margin 0); the exhaustive baseline — like a
naive autotuner — times every lattice point, equivalent lowerings
included, without the measurement cache.  Per space it reports the
predicted and measured seconds of every variant, the survivors, both
winners and the regret (the pruned winner's measured time ÷ the
exhaustive best), timing passes and wall seconds on both sides; in
total the winner agreement (the pruned winner within 1.10× of the
exhaustive optimum, as the reference counts it) and two speedups:
timing passes (the machine-independent search budget, ≥ 4× on the §8
sets) and wall clock.  The reference's benchmark found the wall-clock
gain "compressed" on a CPU host; this study measures it on the card.

A timing pass on the card is the session timer's: the variant captured
once into a CUDA graph and replayed ``trials`` times between CUDA
events.  Each side's ``timer_s`` (host seconds inside timing passes)
and ``replay_s`` (``trials`` × the median of each pass) show how much of
its wall time capture and warm-up took.

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.autotune --profile h100.json --trials 3
    python -m repro_torch.studies.autotune --device cpu --trials 1

Without ``--profile``, or with a path that does not exist yet, the base
battery is calibrated first on ``--device`` (and saved to that path when
one is given), as the paper's figures do.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.session import PerfSession
from repro_torch.core.uipick import (
    MeasurementKernel,
    TimerResult,
    TimingStats,
    default_timer,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import (
    MachineProfile,
    load_profile,
    save_profile,
)
from repro_torch.tuning import (
    SECTION8_SPACE_TAGS,
    enumerate_space,
    exhaustive_search,
    tune_space,
)

#: the pruned winner "agrees" within this factor of the exhaustive best
AGREEMENT_FACTOR = 1.10


class _SpentTimer:
    """A timer that also sums the host seconds of its own passes and the
    seconds they replayed (trials × median)."""

    def __init__(self, timer: Callable[[MeasurementKernel, int],
                                       TimerResult]):
        self._timer = timer
        self.timer_s = 0.0
        self.replay_s = 0.0

    def __call__(self, kernel: MeasurementKernel, trials: int) -> TimerResult:
        t0 = time.perf_counter()
        res = self._timer(kernel, trials)
        self.timer_s += time.perf_counter() - t0
        self.replay_s += trials * TimingStats.coerce(res).median
        return res


def autotune(profile: MachineProfile, *, trials: int = 8,
             model: str = "base", device: DeviceLike = "cuda",
             timer: Optional[Callable] = None) -> Dict[str, Any]:
    """The pruned search and the exhaustive baseline of each §8 space,
    priced with ``profile``'s ``model`` fit (its recorded tuning is not
    read: every search is cold) and timed through ``timer`` — by default
    on ``device``."""
    base = MachineProfile(fingerprint=profile.fingerprint,
                          fits={model: profile.get_fit(model)},
                          trials=trials)
    spent = _SpentTimer(timer or functools.partial(
        default_timer, device=resolve_device(device)))
    session = PerfSession(base, timer=spent)
    spaces: Dict[str, Dict[str, Any]] = {}
    for name, tags in SECTION8_SPACE_TAGS:
        # the search works on the deduplicated space; the exhaustive
        # baseline, like a naive autotuner, times every lattice point
        space = enumerate_space(name, tags)
        lattice = enumerate_space(name, tags, dedup=False)
        sides = {}
        t_s, r_s, t0 = spent.timer_s, spent.replay_s, time.perf_counter()
        res = tune_space(session, space, model=model, margin=0.0,
                         trials=trials)
        sides["pruned"] = {"wall_s": time.perf_counter() - t0,
                           "timer_s": spent.timer_s - t_s,
                           "replay_s": spent.replay_s - r_s,
                           "timings": res.timings_performed}
        t_s, r_s, t0 = spent.timer_s, spent.replay_s, time.perf_counter()
        ex_winner, ex_measured, ex_timings = exhaustive_search(
            session, lattice, trials=trials, use_cache=False)
        sides["exhaustive"] = {"wall_s": time.perf_counter() - t0,
                               "timer_s": spent.timer_s - t_s,
                               "replay_s": spent.replay_s - r_s,
                               "timings": ex_timings}
        regret = res.choice.measured_s / ex_measured[ex_winner]
        spaces[name] = {
            "n_variants": len(space), "n_lattice": len(lattice),
            "predicted_us": {k: v * 1e6
                             for k, v in res.choice.predicted.items()},
            "confirmed_us": {k: v * 1e6
                             for k, v in res.choice.measured.items()},
            "measured_us": {k: v * 1e6 for k, v in ex_measured.items()},
            "survivors": res.survivors,
            "pruned_winner": res.winner, "exhaustive_winner": ex_winner,
            "regret": regret,
            "agree": res.winner == ex_winner
            or regret <= AGREEMENT_FACTOR,
            **sides,
        }
    pruned = [s["pruned"] for s in spaces.values()]
    exhaustive = [s["exhaustive"] for s in spaces.values()]
    timings = (sum(p["timings"] for p in pruned),
               sum(e["timings"] for e in exhaustive))
    wall = (sum(p["wall_s"] for p in pruned),
            sum(e["wall_s"] for e in exhaustive))
    return {
        "trials": trials, "model": model, "spaces": spaces,
        "winner_agreement": [sum(s["agree"] for s in spaces.values()),
                             len(spaces)],
        "timings": {"pruned": timings[0], "exhaustive": timings[1]},
        "wall_s": {"pruned": wall[0], "exhaustive": wall[1]},
        "speedup_timings_x": timings[1] / max(timings[0], 1),
        "speedup_wall_x": wall[1] / max(wall[0], 1e-12),
    }


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows (``name,us_per_call,derived``)
    of an :func:`autotune` result."""
    out = []
    for name, s in result["spaces"].items():
        out.append(f"autotune.{name}.pruned,"
                   f"{s['pruned']['wall_s'] * 1e6:.0f},"
                   f"{s['pruned']['timings']}")
        out.append(f"autotune.{name}.exhaustive,"
                   f"{s['exhaustive']['wall_s'] * 1e6:.0f},"
                   f"{s['exhaustive']['timings']}")
    agree, total = result["winner_agreement"]
    out.append(f"autotune.winner_agreement,{agree},{total}")
    # us column = total pruned/exhaustive wall; derived = the speedup
    out.append(f"autotune.speedup_wall_x,"
               f"{result['wall_s']['pruned'] * 1e6:.0f},"
               f"{result['speedup_wall_x']:.2f}")
    out.append(f"autotune.speedup_timings_x,"
               f"{result['wall_s']['exhaustive'] * 1e6:.0f},"
               f"{result['speedup_timings_x']:.2f}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.studies.paper_figures import calibrate_base

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.studies.autotune",
        description="Pruned autotuning against exhaustive timing over "
                    "the three §8 variant spaces; prints CSV rows "
                    "(name,us_per_call,derived).")
    ap.add_argument("--profile", default=None,
                    help="machine profile whose 'base' fit prices the "
                         "spaces; calibrated first (and saved here) when "
                         "the file does not exist")
    ap.add_argument("--trials", type=int, default=8,
                    help="timing trials per variant")
    ap.add_argument("--device", default="cuda",
                    help="device to time on (default cuda; 'cpu' times "
                         "the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.profile and Path(args.profile).exists():
        profile = load_profile(
            args.profile,
            expected_fingerprint=DeviceFingerprint.local(device))
    else:
        profile = calibrate_base(device=device, trials=args.trials)
        if args.profile:
            save_profile(profile, args.profile)
    print("name,us_per_call,derived")
    for row in rows(autotune(profile, trials=args.trials, device=device)):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
