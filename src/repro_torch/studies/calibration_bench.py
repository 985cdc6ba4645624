"""Calibration-engine benchmark: the batched ``fit_model`` against the
row-by-row reference engine; the counterpart of the reference's
``benchmarks/calibration_bench.py``.

The paper's usability claim (§7.2) is that black-box calibration is
cheap enough to re-run per machine and per model variant; this bench
pins that cost on a 64-row × 3-seed fit.  The reference arm is
:mod:`repro_torch.core.calibrate_reference` (one expression evaluation
per row, a Jacobian and a host read every step).  The port has no jit,
so "cold" is the batched engine's first call in the process (its
``torch.func`` transforms built and its kernels dispatched for the first
time) and "warm" the mean of five more; nothing is compiled or cached
between them.  All of it is host seconds.  Rows:

  calibration.fit64x3_reference      — row-by-row engine, one full fit
  calibration.fit64x3_batched_cold   — batched engine, first call
  calibration.fit64x3_batched_warm   — batched engine, later calls
  calibration.param_max_rel_diff     — max relative parameter difference

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.calibration_bench
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.calibrate import fit_model
from repro_torch.core.calibrate_reference import reference_fit_model
from repro_torch.core.model import FeatureTable, Model

N_ROWS = 64
SEEDS = 3
WARM_REPEATS = 5

MODEL_EXPR = (
    "p_madd * f_op_float32_madd "
    "+ p_mem * (f_mem_contig_float32_load + f_mem_contig_float32_store) "
    "+ p_gather * f_mem_gather_float32_load "
    "+ p_launch * f_sync_launch_kernel"
)
TRUE_PARAMS = {"p_madd": 2.5e-10, "p_mem": 4.0e-9, "p_gather": 1.6e-8,
               "p_launch": 3.0e-5}


def synthetic_table(n_rows: int = N_ROWS) -> FeatureTable:
    """The reference's deterministic timing table: the shared linear
    model's feature mix (madd / contig / gather / launch) with 1%
    lognormal noise, drawn from ``RandomState(20190417)``."""
    rng = np.random.RandomState(20190417)
    feats = {
        "f_op_float32_madd": 10 ** rng.uniform(5, 9, n_rows),
        "f_mem_contig_float32_load": 10 ** rng.uniform(4, 8, n_rows),
        "f_mem_contig_float32_store": 10 ** rng.uniform(4, 8, n_rows),
        "f_mem_gather_float32_load": 10 ** rng.uniform(3, 7, n_rows),
        "f_sync_launch_kernel": np.ones(n_rows),
    }
    t = (TRUE_PARAMS["p_madd"] * feats["f_op_float32_madd"]
         + TRUE_PARAMS["p_mem"] * (feats["f_mem_contig_float32_load"]
                                   + feats["f_mem_contig_float32_store"])
         + TRUE_PARAMS["p_gather"] * feats["f_mem_gather_float32_load"]
         + TRUE_PARAMS["p_launch"])
    t = t * np.exp(rng.normal(0.0, 0.01, n_rows))
    ids = sorted(feats) + ["f_wall_time_cpu_host"]
    vals = np.stack([feats[f] for f in sorted(feats)] + [t], axis=1)
    return FeatureTable(ids, vals, [f"synth{i}" for i in range(n_rows)])


def calibration_bench(n_rows: int = N_ROWS,
                      seeds: int = SEEDS) -> Dict[str, Any]:
    """Host seconds of one reference fit, the batched engine's first
    call and its later calls, and the engines' largest relative
    parameter difference."""
    table = synthetic_table(n_rows)
    model = Model("f_wall_time_cpu_host", MODEL_EXPR)
    t0 = time.perf_counter()
    params_ref, _ = reference_fit_model(model, table.rows(), nonneg=True,
                                        seeds=seeds)
    t_ref = time.perf_counter() - t0

    t0 = time.perf_counter()
    fit_model(model, table, nonneg=True, seeds=seeds)
    t_cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(WARM_REPEATS):
        fit = fit_model(model, table, nonneg=True, seeds=seeds)
    t_warm = (time.perf_counter() - t0) / WARM_REPEATS

    rel = max(abs(fit.params[n] - params_ref[n])
              / max(abs(params_ref[n]), 1e-30) for n in params_ref)
    return {"reference_s": t_ref, "batched_cold_s": t_cold,
            "batched_warm_s": t_warm, "param_max_rel_diff": rel,
            "params": dict(fit.params)}


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a
    :func:`calibration_bench` result."""
    r = result
    return [
        f"calibration.fit64x3_reference,{r['reference_s'] * 1e6:.0f},",
        f"calibration.fit64x3_batched_cold,{r['batched_cold_s'] * 1e6:.0f},"
        f"{r['reference_s'] / r['batched_cold_s']:.1f}x",
        f"calibration.fit64x3_batched_warm,{r['batched_warm_s'] * 1e6:.0f},"
        f"{r['reference_s'] / r['batched_warm_s']:.0f}x",
        f"calibration.param_max_rel_diff,{r['param_max_rel_diff']:.2e},",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.studies.calibration_bench",
        description="The batched fit against the row-by-row reference "
                    "engine on a 64-row table; prints CSV rows "
                    "(name,us_per_call,derived)."
    ).parse_args(argv)
    print("name,us_per_call,derived")
    for row in rows(calibration_bench()):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
