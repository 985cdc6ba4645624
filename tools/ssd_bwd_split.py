#!/usr/bin/env python3
"""Where the SSD backward's time goes, per pass, on one NVIDIA GPU, from
the ``src/`` tree given (so two trees compare in one machine).

    python3 tools/ssd_bwd_split.py [--src path/to/src] [--reps 10]

At zamba2-7b's layer (B 1, S 4096, H 112, P = N = 64, chunk 256, f32):
``mamba2_ssd_bwd_cuda`` timed whole (``chip_smoke.time_ms``, median of
10), each pass's kernel from ``chip_smoke.pass_ms`` (a ``torch.profiler``
trace of ``--reps`` calls: the chained scans' two passes where the tree
has ``mamba2_ssd.bwd_route``, else the five passes), and the peak memory
a call adds.  Also the forward ``mamba2_ssd_cuda`` at S 8192 (PERF.md's
forward row).  Prints one JSON line, then the card's name and power
limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 4096, 112, 64, 64, 256)   # B, S, H, P, N, chunk
FORWARD_S = 8192
# the five-pass route's kernels, by pass, as a profiler names them
FIVE_PASS_KERNELS = (("a", "chunk_state_kernel<false>"),
                     ("b", "state_pass_kernel<false>"),
                     ("a'", "chunk_state_kernel<true>"),
                     ("b'", "state_pass_kernel<true>"),
                     ("c'", "chunk_grad_kernel"))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import SSD_BWD_PASS_KERNELS, pass_ms, ssd_inputs, time_ms
    from repro_torch.kernels import mamba2_ssd

    dev = torch.device("cuda")
    B, S, H, P, N, chunk = SHAPE
    gen = torch.Generator(device=dev).manual_seed(17)
    x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
    dy = torch.randn(B, S, H, P, generator=gen, device=dev)
    chain = (hasattr(mamba2_ssd, "bwd_route") and mamba2_ssd.bwd_route(
        P, N, mamba2_ssd.inner_chunk(chunk)) == "chain")

    def backward():
        return mamba2_ssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy, chunk)

    out = {"src": args.src, "shape": list(SHAPE),
           "route": "chain" if chain else "passes", "ms": time_ms(backward),
           "pass_ms": pass_ms(
               backward, SSD_BWD_PASS_KERNELS if chain else FIVE_PASS_KERNELS,
               "SSD backward", lambda: mamba2_ssd.backward_launches,
               args.reps)}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backward()
    torch.cuda.synchronize()
    out["peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    del x, da, bm, cm, dy
    x, da, bm, cm = ssd_inputs(gen, dev, B, FORWARD_S, H, P, N)
    out["forward_ms"] = time_ms(mamba2_ssd.mamba2_ssd_cuda, x, da, bm, cm,
                                chunk)
    out["forward_shape"] = [B, FORWARD_S, H, P, N, chunk]
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
