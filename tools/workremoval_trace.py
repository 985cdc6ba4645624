#!/usr/bin/env python3
"""Where the stripped battery kernel's time goes, on one NVIDIA GPU.

    python3 tools/workremoval_trace.py [--n 1024] [--tile 64] [--replays 20]

``matmul_sq`` (f32, prefetch, the tile given) and its ``remove_work``
strip of the first operand, each captured as a CUDA graph as the battery
times it.  For each: the median time of one replay between CUDA events,
and a ``torch.profiler`` trace of ``--replays`` replays giving every
device kernel's time a replay.  The replay's time less the kernels' sum
is the device's idle time between the graph's nodes.  Prints one JSON
line, then the card's name and power limit.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def trace(kernel, args, replays: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph, out = kernel.capture(args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    per_kernel = defaultdict(lambda: {"calls": 0, "us": 0.0})
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = per_kernel[ev.name]
            k["calls"] += 1
            k["us"] += ev.time_range.elapsed_us()
    del out
    graph.reset()
    kernels = {name: {"calls_per_replay": k["calls"] / replays,
                      "us_per_replay": k["us"] / replays}
               for name, k in sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1]["us"])}
    busy = sum(k["us_per_replay"] for k in kernels.values())
    replay = statistics.median(times)
    return {"replay_us": replay, "kernels_us": busy,
            "idle_us": replay - busy, "kernels": kernels}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("workremoval_trace: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import uipick
    from repro_torch.core.workremoval import remove_work

    torch.backends.cuda.matmul.allow_tf32 = False
    (kern,) = uipick.KernelCollection(uipick.ALL_GENERATORS) \
        .generate_kernels(["matmul_sq", f"n:{args.n}", "dtype:float32",
                           "prefetch:True", f"tile:{args.tile}"])
    kargs = kern.make_args(torch.device("cuda"))
    stripped = uipick.MeasurementKernel(
        name=f"{kern.name}_stripped",
        fn=remove_work(kern.fn, *kargs, remove_args=(0,)),
        make_args=kern.make_args, tags=dict(kern.tags))
    out = {"kernel": kern.name, "replays": args.replays}
    for label, k in (("unstripped", kern), ("stripped", stripped),
                     ("unstripped_again", kern)):
        out[label] = trace(k, kargs, args.replays)
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
