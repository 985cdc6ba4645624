"""Cross-machine study benchmark: the one-battery multi-fit engine; the
counterpart of the reference's ``benchmarks/study_bench.py``.

Times a full synthetic three-device study (gather, zoo multi-fit,
holdout evaluation) twice, then the comparison of its profiles; the
closing rows carry the closed-loop recovery error (the accuracy claim,
as a number).  The reference's second pass reuses its jit-compiled
solvers; the port compiles nothing and its study keeps no cache between
calls (each pass generates fresh kernels, counts them and fits again),
so the second pass repeats the same work and shows only what a warm
process adds: imported modules, the source-signature memo and torch's
own dispatch caches.  All of it is host seconds: the synthetic devices
time nothing on the card.

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.study_bench
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.studies import STUDY_TAGS, compare_profiles, run_study
from repro_torch.testing.synthdev import default_fleet

NOISE = 0.02


def _one_fleet_study(trials: int, tags) -> list:
    return [run_study(fingerprint=device.fingerprint, timer=device.timer,
                      tags=tags, trials=trials)
            for device in default_fleet(noise=NOISE)]


def study_bench(tags=tuple(STUDY_TAGS)) -> Dict[str, Any]:
    """Host seconds of two fleet studies and of their comparison, and
    each device's worst recoverable-parameter error and held-out gmre."""
    t0 = time.perf_counter()
    profiles = _one_fleet_study(3, tags)
    cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    _one_fleet_study(4, tags)
    warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    report = compare_profiles(profiles)
    compare_s = time.perf_counter() - t0

    recovery = {}
    for device, profile in zip(default_fleet(noise=NOISE), profiles):
        fit = profile.fits[device.truth.name]
        worst = max(abs(fit.params[p] - device.p_true[p]) / device.p_true[p]
                    for p in device.truth.recoverable)
        recovery[device.name] = {
            "worst_param_rel_err": worst,
            "gmre": report.summary[device.fingerprint.id][device.truth.name]}
    return {"cold_s": cold, "warm_s": warm, "compare_s": compare_s,
            "recovery": recovery}


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a :func:`study_bench`
    result."""
    r = result
    out = [
        f"study.fleet_cold_3dev,{r['cold_s'] * 1e6:.0f},",
        f"study.fleet_warm_3dev,{r['warm_s'] * 1e6:.0f},"
        f"{r['cold_s'] / r['warm_s']:.2f}x",
        f"study.compare_3dev,{r['compare_s'] * 1e6:.0f},",
    ]
    for name, rec in r["recovery"].items():
        out.append(f"study.recovery_{name},"
                   f"{rec['worst_param_rel_err'] * 100:.4f},"
                   f"{rec['gmre'] * 100:.2f}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.studies.study_bench",
        description="A synthetic three-device zoo study, twice, and its "
                    "comparison; prints CSV rows (name,us_per_call,"
                    "derived)."
    ).parse_args(argv)
    print("name,us_per_call,derived")
    for row in rows(study_bench()):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
