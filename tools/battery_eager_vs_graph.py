#!/usr/bin/env python3
"""Time three battery kernels of the port both ways on one NVIDIA GPU.

    python3 tools/battery_eager_vs_graph.py [--trials 20]

Eager: the measurement kernel's Python function between two CUDA events,
one host-issued launch per aten op.  Graph: one ``graph.replay()`` of the
kernel captured into a CUDA graph, the way calibration times the battery
(``MeasurementKernel.time_stats``).  Prints the median of each per kernel,
then the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

NAMES = ("empty_n16", "stream_contig_n1048576_a2_float32",
         "madd_n65536_i256_float32")


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("battery_eager_vs_graph: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import uipick

    dev = torch.device("cuda")
    kernels = {k.name: k for k in uipick.KernelCollection(
        uipick.ALL_GENERATORS).generate_kernels(
            ["empty_kernel", "mem_stream", "flops_madd_pattern",
             "nelements:16,65536,1048576", "pattern:contig", "n_arrays:2",
             "iters:256", "dtype:float32"],
            uipick.MatchCondition.INTERSECT)}
    for name in NAMES:
        k = kernels[name]
        kargs = k.make_args(dev)
        for _ in range(3):
            k.fn(*kargs)
        torch.cuda.synchronize()
        eager = []
        for _ in range(args.trials):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            k.fn(*kargs)
            end.record()
            end.synchronize()
            eager.append(start.elapsed_time(end) * 1e3)
        graph = k.time_stats(trials=args.trials, device=dev).median * 1e6
        print(f"{name}: eager {float(np.median(eager)):.4g} us, one graph "
              f"replay {graph:.4g} us (median of {args.trials})", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
