"""Bench harness; the counterpart of the reference's ``benchmarks/run.py``.

    python -m repro_torch.studies.run                    # all benches
    python -m repro_torch.studies.run fig7 fig9          # a subset
    python -m repro_torch.studies.run calibration --device cpu

Prints ``name,us_per_call,derived`` CSV rows.  A bench that raises
becomes a ``<name>.FAILED`` row and the harness goes on; every bench
ends with a ``<name>.bench_wall_s`` row (host µs, as the reference's).

Benches, in the reference's order:

  calibration  batched against row-by-row ``fit_model`` on a 64-row table
  study        synthetic three-device zoo study, twice, and its compare
  predict      ``PerfSession`` single against batched prediction
  serve        serving daemon: serial loop against coalesced bursts
  counting     symbolic count families against counting every size;
               ``predict_batch`` with and without duplicates
  fleet        routing decision time and makespan against round-robin
  autotune     pruned against exhaustive timing over the three §8 spaces
  fig1 fig2 fig5 fig7 fig8 fig9 table3
               the paper's figures (:mod:`repro_torch.studies.paper_figures`)
  roofline     three-term roofline per (arch × shape) from the dry-run's
               records under ``runs/dryrun_torch``

``calibration``, ``study``, ``predict``, ``serve``, ``counting`` and
``fleet`` time the host and need no card.  ``autotune`` and the figures
time kernels on ``--device`` (default ``cuda``); ``autotune``, Figs 7–9
and Table 3 read the ``base`` fit, calibrated on ``--device`` once per
run.  ``roofline`` reads files and needs no card.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional

from repro_torch.device import resolve_device


class _Context:
    """What the benches share in one run: the device, and the base
    profile, calibrated at most once."""

    def __init__(self, device):
        self.device = device
        self._profile = None

    def profile(self):
        from repro_torch.studies.paper_figures import calibrate_base

        if self._profile is None:
            self._profile = calibrate_base(device=self.device)
        return self._profile


def _calibration(ctx: _Context) -> List[str]:
    from repro_torch.studies import calibration_bench as b
    return b.rows(b.calibration_bench())


def _study(ctx: _Context) -> List[str]:
    from repro_torch.studies import study_bench as b
    return b.rows(b.study_bench())


def _predict(ctx: _Context) -> List[str]:
    from repro_torch.studies import predict_bench as b
    return b.rows(b.predict_bench())


def _serve(ctx: _Context) -> List[str]:
    from repro_torch.studies import serve_bench as b
    return b.rows(b.serve_bench())


def _counting(ctx: _Context) -> List[str]:
    from repro_torch.studies import counting_bench as b
    return b.rows(b.counting_bench())


def _fleet(ctx: _Context) -> List[str]:
    from repro_torch.studies import fleet_bench as b
    return b.rows(b.fleet_bench())


def _autotune(ctx: _Context) -> List[str]:
    from repro_torch.studies import autotune as b
    return b.rows(b.autotune(ctx.profile(), device=ctx.device))


def _roofline(ctx: _Context) -> List[str]:
    from repro_torch.studies import roofline_bench as b
    return b.roofline_rows()


def _figure(name: str) -> Callable[[_Context], List[str]]:
    def run(ctx: _Context) -> List[str]:
        from repro_torch.studies import paper_figures as pf
        profile = ctx.profile() if name in pf.PROFILE_FIGURES else None
        return pf.run_figure(name, profile, device=ctx.device)
    return run


BENCHES: Dict[str, Callable[[_Context], List[str]]] = {
    "calibration": _calibration,
    "study": _study,
    "predict": _predict,
    "serve": _serve,
    "counting": _counting,
    "fleet": _fleet,
    "autotune": _autotune,
    **{name: _figure(name) for name in
       ("fig1", "fig2", "fig5", "fig7", "fig8", "fig9", "table3")},
    "roofline": _roofline,
}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.studies.run",
        description="Run the benches and print their CSV rows "
                    "(name,us_per_call,derived).")
    ap.add_argument("benches", nargs="*", metavar="BENCH",
                    help=f"benches to run (default all: {list(BENCHES)})")
    ap.add_argument("--device", default="cuda",
                    help="device the figures and autotune time on "
                         "(default cuda; 'cpu' times the host)")
    args = ap.parse_args(argv)
    only = set(args.benches) or set(BENCHES)
    unknown = only - set(BENCHES)
    if unknown:
        raise SystemExit(f"unknown bench(es): {sorted(unknown)}; "
                         f"available: {sorted(BENCHES)}")
    ctx = _Context(resolve_device(args.device))
    print("name,us_per_call,derived")
    for name, bench in BENCHES.items():
        if name not in only:
            continue
        t0 = time.time()
        try:
            for row in bench(ctx):
                print(row, flush=True)
        except Exception as e:  # noqa: BLE001 — a bench failure is a row
            print(f"{name}.FAILED,0,{type(e).__name__}:{str(e)[:60]}")
        print(f"{name}.bench_wall_s,{(time.time() - t0) * 1e6:.0f},",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
