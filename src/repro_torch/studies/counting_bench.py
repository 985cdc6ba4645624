"""Counting-engine benchmark: amortized symbolic counts against counting
every size; the counterpart of the reference's
``benchmarks/counting_bench.py``.

The paper's amortization claim is that operation counts are gathered
symbolically once and re-evaluated "in microseconds for any problem
size".  This bench pins the port's implementation of that claim:

* **count-matrix construction** — the count rows of one symbolic kernel
  family over a 24-point size sweep, cold as
  :func:`~repro_torch.core.counting.count_fn` at every size point (the
  port's counterpart of the reference's trace per size: one fake-tensor
  pass each), against the count engine (the minimal probe grid and
  vectorized polynomial evaluation), and the warm engine (no counting
  pass — polynomial evaluation only);
* **serving dedup** — ``predict_batch`` over 256 items, every item
  distinct, against the same batch as 8 unique kernels repeated
  (counted once, rows shared).

All of it is host seconds: counting runs on fake tensors and launches
nothing.

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.counting_bench
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.api import PerfSession
from repro_torch.core.countengine import CountEngine
from repro_torch.core.counting import count_fn
from repro_torch.core.uipick import FamilySpec, Generator, MeasurementKernel
from repro_torch.studies.serve_bench import bench_profile

N_SIZES = 24                      # size sweep for the count-matrix bench
BATCH = 256                       # serving batch size
UNIQUE = 8                        # distinct kernels in the deduped batch


def _build_mm(*, n: int) -> MeasurementKernel:
    def fn(a, b):
        return torch.tanh(a @ b) + a

    def make_args(device):
        x = torch.ones((n, n), dtype=torch.float32, device=device)
        return x, x

    return MeasurementKernel(name=f"mm_{n}", fn=fn, make_args=make_args,
                             tags={"n": n}, sizes={"n": n})


def family_kernels(sizes: List[int]) -> List[MeasurementKernel]:
    """One symbolic matmul family across a size sweep — degree-3 counts,
    rebuilt from 4 probe counts."""
    gen = Generator("bench_matmul", frozenset({"bench"}),
                    arg_space=dict(n=tuple(sizes)), build=_build_mm,
                    family=FamilySpec(var_degrees={"n": 3}))
    return list(gen.variants({}))


def serving_kernels(n_unique: int, total: int) -> List[MeasurementKernel]:
    """``total`` items drawn from ``n_unique`` distinct kernels, each with
    a stable content signature (so the dedup path can collapse them)."""
    unique = []
    for i in range(n_unique):
        size = 16 * (i + 1)

        def make_args(device, s=size):
            return (torch.ones((s,), dtype=torch.float32, device=device),)

        unique.append(MeasurementKernel(
            name=f"serve_{size}", fn=lambda x: x * 2.0 + 1.0,
            make_args=make_args, tags={"n": size}, sizes={"n": size},
            code_sig=f"counting_bench_v1_{i}"))
    return [unique[i % n_unique] for i in range(total)]


def counting_bench(n_sizes: int = N_SIZES, batch: int = BATCH,
                   unique: int = UNIQUE) -> Dict[str, Any]:
    """Host seconds per kernel of each counting arm and each serving
    batch, with the engines' counting passes and hits."""
    sizes = [16 * (i + 1) for i in range(n_sizes)]
    kernels = family_kernels(sizes)
    count_fn(kernels[0].fn, *kernels[0].make_args("meta"))   # warm imports

    t0 = time.perf_counter()
    direct = [count_fn(k.fn, *k.make_args("meta")) for k in kernels]
    t_trace = (time.perf_counter() - t0) / len(kernels)

    engine = CountEngine()
    t0 = time.perf_counter()
    cold_rows = engine.counts_batch(kernels)
    t_cold = (time.perf_counter() - t0) / len(kernels)
    traces_cold = engine.trace_count

    t0 = time.perf_counter()
    warm_rows = engine.counts_batch(kernels)      # family now in-process
    t_warm = (time.perf_counter() - t0) / len(kernels)

    for want, row in zip(direct, cold_rows):
        for fid, v in want.items():
            if abs(row[fid] - v) > 1e-6 * max(abs(v), 1.0):
                raise AssertionError(f"family row {fid}: {row[fid]} != {v}")
    if engine.trace_count != traces_cold:
        raise AssertionError("the warm engine counted again")
    if [dict(r) for r in warm_rows] != [dict(r) for r in cold_rows]:
        raise AssertionError("warm rows differ from cold rows")

    session = PerfSession.open(bench_profile())
    distinct = serving_kernels(batch, batch)
    duplicated = serving_kernels(unique, batch)
    session.predict_batch(distinct)          # warm the count memo
    session.predict_batch(duplicated)

    t0 = time.perf_counter()
    session.predict_batch(distinct)
    t_nodedup = (time.perf_counter() - t0) / batch

    t0 = time.perf_counter()
    preds = session.predict_batch(duplicated)
    t_dedup = (time.perf_counter() - t0) / batch

    return {
        "sizes": len(sizes),
        "trace_per_size_s": t_trace,
        "family_cold_s": t_cold,
        "family_warm_s": t_warm,
        "family_cold_traces": traces_cold,
        "predict_no_dedup_s": t_nodedup,
        "predict_dedup_s": t_dedup,
        "batch": batch,
        "unique": unique,
        "session_traces": session.engine.trace_count,
        "session_hits": session.engine.hits,
        "breakdown_residual_s": abs(sum(preds[-1].breakdown.values())
                                    - preds[-1].seconds),
    }


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a :func:`counting_bench`
    result."""
    r = result
    return [
        f"counting.trace_per_size_us,{r['trace_per_size_s'] * 1e6:.1f},"
        f"sizes={r['sizes']}",
        f"counting.family_cold_us,{r['family_cold_s'] * 1e6:.1f},"
        f"{r['trace_per_size_s'] / r['family_cold_s']:.1f}x_traces="
        f"{r['family_cold_traces']}",
        f"counting.family_warm_us,{r['family_warm_s'] * 1e6:.1f},"
        f"{r['trace_per_size_s'] / r['family_warm_s']:.1f}x",
        f"counting.predict_no_dedup_us,{r['predict_no_dedup_s'] * 1e6:.2f},"
        f"unique={r['batch']}",
        f"counting.predict_dedup_us,{r['predict_dedup_s'] * 1e6:.2f},"
        f"{r['predict_no_dedup_s'] / r['predict_dedup_s']:.1f}x_unique="
        f"{r['unique']}",
        f"counting.engine_traces,{r['session_traces']},"
        f"hits={r['session_hits']}",
        f"counting.breakdown_residual,{r['breakdown_residual_s'] * 1e6:.3g},",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.studies.counting_bench",
        description="Symbolic count families against counting every size, "
                    "and predict_batch with and without duplicates; prints "
                    "CSV rows (name,us_per_call,derived)."
    ).parse_args(argv)
    print("name,us_per_call,derived")
    for row in rows(counting_bench()):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
