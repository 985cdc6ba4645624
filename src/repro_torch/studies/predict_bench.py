"""Prediction benchmark: single against batched ``PerfSession`` calls; the
counterpart of the reference's ``benchmarks/predict_bench.py``.

The facade's throughput claim is that prediction cost scales with batch
size, not Python dispatch: ``predict_batch`` packs every kernel into one
dense feature matrix and runs ONE breakdown evaluation, while a loop of
single ``predict`` calls pays per-call dispatch and assembly.  This
bench pins that claim as host microseconds per kernel for both paths
(counting amortized out: counts are memoized on the kernels, as in any
warm serving process) and the batched-over-single ratio.  The port
evaluates in float64 on the host and compiles nothing, so the warm-up
calls only fill its evaluator and count memos.

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.predict_bench
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.api import PerfSession
from repro_torch.studies.serve_bench import bench_kernels, bench_profile

N_KERNELS = 256
REPEATS = 5


def predict_bench(n_kernels: int = N_KERNELS,
                  repeats: int = REPEATS) -> Dict[str, Any]:
    """Host seconds per kernel of single and batched prediction over
    ``n_kernels`` elementwise kernels on the bench's synthetic fit."""
    session = PerfSession.open(bench_profile())
    kernels = bench_kernels(n_kernels)
    for k in kernels:
        k.counts()                       # memoize counting out of the loop
    session.predict(kernels[0])          # warm both paths
    session.predict_batch(kernels)

    t0 = time.perf_counter()
    for _ in range(repeats):
        for k in kernels:
            session.predict(k)
    single = (time.perf_counter() - t0) / (repeats * n_kernels)

    t0 = time.perf_counter()
    for _ in range(repeats):
        preds = session.predict_batch(kernels)
    batched = (time.perf_counter() - t0) / (repeats * n_kernels)

    return {"single_s": single, "batched_s": batched,
            "batch_size": n_kernels, "eval_calls": session.eval_calls,
            "timings": session.timer.calls,
            "breakdown_residual_s": abs(sum(preds[-1].breakdown.values())
                                        - preds[-1].seconds)}


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a :func:`predict_bench`
    result."""
    r = result
    return [
        f"predict.single_us_per_kernel,{r['single_s'] * 1e6:.2f},",
        f"predict.batched_us_per_kernel,{r['batched_s'] * 1e6:.2f},"
        f"{r['single_s'] / r['batched_s']:.1f}x",
        f"predict.batch_size,{r['batch_size']},evals={r['eval_calls']}",
        f"predict.breakdown_residual,{r['breakdown_residual_s'] * 1e6:.3g},",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.studies.predict_bench",
        description="Single predict calls against one predict_batch over "
                    "256 kernels; prints CSV rows (name,us_per_call,"
                    "derived)."
    ).parse_args(argv)
    print("name,us_per_call,derived")
    for row in rows(predict_bench()):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
