"""Serving-daemon benchmark: coalesced concurrent bursts against serial
``predict`` loops; the counterpart of the reference's
``benchmarks/serve_bench.py``.

The daemon's claim is that concurrency creates the batch: K in-flight
requests park on the :class:`~repro_torch.serving.CoalescingBatcher` and
drain as one batched evaluation, so a burst's wall time scales with one
evaluation, not with K Python dispatches.  This bench states service
latency as numbers — p50/p99 per-request latency of the serial loop and
of the coalesced concurrent burst, the burst's throughput ratio, and
the count of batched evaluations that explains it.  All of it is host
time: serving prices from counts and runs no kernel.

CLI (the reference's CSV rows ``name,us_per_call,derived`` on stdout)::

    python -m repro_torch.studies.serve_bench
    python -m repro_torch.studies.serve_bench --profile h100_profile.json

Without ``--profile`` it serves the reference bench's synthetic
``ovl_flop_mem`` fit; with one it serves that profile's default fit.
"""
from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from repro_torch.api import PerfSession
from repro_torch.core.uipick import MeasurementKernel
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.profile import MachineProfile, load_profile
from repro_torch.serving import CoalescingBatcher

N_UNIQUE = 8
BURST = 64
ROUNDS = 5


def bench_profile() -> MachineProfile:
    """The reference bench's ready-made profile (a synthetic
    ``ovl_flop_mem`` fit: the bench measures serving, not calibration)."""
    from repro_torch.core.calibrate import FitResult
    from repro_torch.profiles.profile import ModelFit
    from repro_torch.studies.zoo import OVL_FLOP_MEM

    fit = FitResult(params={"p_madd": 5e-11, "p_mem": 4e-10,
                            "p_launch": 3e-6, "p_edge": 40.0},
                    residual_norm=0.0, iterations=1, converged=True)
    return MachineProfile(
        fingerprint=DeviceFingerprint(platform="synth",
                                      device_kind="predict-bench",
                                      n_devices=1),
        fits={OVL_FLOP_MEM.name: ModelFit.from_fit(OVL_FLOP_MEM.model(),
                                                   fit)},
        trials=3)


def bench_kernels(n: int) -> List[MeasurementKernel]:
    """``n`` elementwise kernels (``x * 2 + 1`` at 8, 16, … elements)."""
    kernels = []
    for i in range(n):
        size = 8 * (i + 1)

        def make_args(device, s=size):
            return (torch.ones((s,), dtype=torch.float32, device=device),)

        kernels.append(MeasurementKernel(
            name=f"bench_{size}", fn=lambda x: x * 2.0 + 1.0,
            make_args=make_args, tags={"n": size}, sizes={"n": size}))
    return kernels


def _pct(samples: List[float], q: float) -> float:
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def serve_bench(profile: Optional[MachineProfile] = None) -> Dict[str, Any]:
    """Serial ``predict`` against coalesced bursts of ``BURST`` concurrent
    requests over ``N_UNIQUE`` kernels, ``ROUNDS`` rounds each.  Returns
    per-request p50/p99 seconds of both, the wall seconds a request of
    both, their ratio, the burst's batched evaluations and the timings
    the session performed (0)."""
    session = PerfSession.open(profile if profile is not None
                               else bench_profile())
    unique = bench_kernels(N_UNIQUE)
    for k in unique:
        k.counts()                      # counting out of the timed loops
    requests = [unique[i % N_UNIQUE] for i in range(BURST)]
    session.predict_batch(requests)     # warm the evaluator and the memos
    session.predict(unique[0])

    # serial baseline: one predict (one batched evaluation) per request
    serial: List[float] = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        for k in requests:
            t = time.perf_counter()
            session.predict(k)
            serial.append(time.perf_counter() - t)
    serial_wall = (time.perf_counter() - t0) / (ROUNDS * BURST)

    # coalesced burst: BURST concurrent callers share one evaluation;
    # hold/release makes every drain a full burst
    batcher = CoalescingBatcher(session, max_wait_s=0.002)
    coalesced: List[float] = []

    def one_request(k) -> float:
        t = time.perf_counter()
        batcher.predict(k, timeout=60.0)
        return time.perf_counter() - t

    def burst_round(pool, record) -> None:
        batcher.hold()
        futs = [pool.submit(one_request, k) for k in requests]
        while batcher.pending_count() < BURST:
            time.sleep(0.0002)
        batcher.release()
        results = [f.result(timeout=60.0) for f in futs]
        if record is not None:
            record.extend(results)

    try:
        with ThreadPoolExecutor(max_workers=BURST) as pool:
            burst_round(pool, None)     # warm the pool's threads
            evals0 = session.eval_calls
            t0 = time.perf_counter()
            for _ in range(ROUNDS):
                burst_round(pool, coalesced)
            burst_wall = (time.perf_counter() - t0) / (ROUNDS * BURST)
        evals = session.eval_calls - evals0
    finally:
        batcher.close()
    return {
        "fingerprint": session.profile.fingerprint.id,
        "serial_p50_s": _pct(serial, 0.50),
        "serial_p99_s": _pct(serial, 0.99),
        "coalesced_p50_s": _pct(coalesced, 0.50),
        "coalesced_p99_s": _pct(coalesced, 0.99),
        "serial_s_per_request": serial_wall,
        "burst_s_per_request": burst_wall,
        "throughput_ratio": serial_wall / burst_wall,
        "burst_evals": evals,
        "requests": ROUNDS * BURST,
        "timings": session.timer.calls,
    }


def rows(result: Dict[str, Any]) -> List[str]:
    """The reference benchmark's CSV rows of a :func:`serve_bench`
    result."""
    r = result
    return [
        f"serve.serial_p50_us,{r['serial_p50_s'] * 1e6:.2f},",
        f"serve.serial_p99_us,{r['serial_p99_s'] * 1e6:.2f},",
        f"serve.coalesced_p50_us,{r['coalesced_p50_s'] * 1e6:.2f},",
        f"serve.coalesced_p99_us,{r['coalesced_p99_s'] * 1e6:.2f},",
        f"serve.burst_us_per_request,{r['burst_s_per_request'] * 1e6:.2f},"
        f"{r['throughput_ratio']:.1f}x",
        f"serve.burst_evals,{r['burst_evals']},"
        f"{r['requests'] / max(r['burst_evals'], 1):.0f}_reqs_per_eval",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.studies.serve_bench",
        description="Serial predict against coalesced concurrent bursts; "
                    "prints CSV rows (name,us_per_call,derived).")
    ap.add_argument("--profile", default=None,
                    help="machine profile to serve (default: a synthetic "
                         "ovl_flop_mem fit); opening it times nothing")
    args = ap.parse_args(argv)
    profile = load_profile(args.profile) if args.profile else None
    print("name,us_per_call,derived")
    for row in rows(serve_bench(profile)):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
