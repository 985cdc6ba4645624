#!/usr/bin/env python3
"""Whether ``torch.profiler`` traces in one process lose kernel records,
and after what, on one NVIDIA GPU.

    python3 tools/trace_loss_probe.py [--sequence ssd,ssd,attn,ssd,flex,ssd]
        [--reps 10]

In a fresh process, the ``--sequence`` of steps in order: ``ssd`` a
trace (``chip_smoke.traced``: ``--reps`` calls, 0.25 s of idle card on
both sides) of the SSD backward at zamba2-7b's layer (chip_smoke.py's
``SSD_BWD_CASES[0]``, the chained scans' two pass kernels a call);
``attn`` the same of the bf16 attention backward at gemma2-9b's global
layer (``ATTN_BWD_CASES[0]``, its three pass kernels), as phase 16 (a)
traces it; ``flex`` phase 16 (a)'s library call, ``torch.compile``'d
``flex_attention`` forward and backward, compiled and run once.  For
each trace: the calls the wrapper counted and the pass kernels the
trace holds.  ``chip_smoke.py`` phase 17 (a)'s SSD trace, late in a long
process, has held fewer than it launched.  Prints one JSON line, then
the card's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sequence", default="ssd,ssd,ssd,ssd,ssd,ssd")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_loss_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import (ATTN_BWD_CASES, ATTN_BWD_PASS_KERNELS,
                            SSD_BWD_CASES, SSD_BWD_PASS_KERNELS, attn_inputs,
                            flex_library, ssd_inputs, traced)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd

    dev = torch.device("cuda")
    label, B, S, H, P, N, chunk, _ = SSD_BWD_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
    dy = torch.randn(B, S, H, P, generator=gen, device=dev)
    _, Ba, Sq, _, Hq, Hkv, D, Dv, causal, window, cap, qs = ATTN_BWD_CASES[0]
    scale = 1.0 / math.sqrt(D)
    q, k, v = attn_inputs(gen, dev, torch.bfloat16, Ba, Sq, Hq, Hkv, D, qs)
    dout = torch.randn(Ba, Sq, Hq, Dv, generator=gen,
                       device=dev).to(torch.bfloat16)
    _, lse = fa.flash_attention_lse_cuda(q, k, v, causal, window, cap, scale)
    steps = []
    for step in args.sequence.split(","):
        if step == "flex":
            kw = dict(causal=causal, window=window, softcap=cap)
            flex = flex_library(kw, Sq, dev)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(flex(*leaves), leaves, dout)
            torch.cuda.synchronize()
            steps.append({"step": step})
            continue
        if step == "ssd":
            rose, found = traced(
                lambda: mamba2_ssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy,
                                                       chunk),
                SSD_BWD_PASS_KERNELS,
                lambda: mamba2_ssd.bwd_route_launches["chain"], args.reps)
        elif step == "attn":
            rose, found = traced(
                lambda: fa.flash_attention_bwd_cuda(
                    dout, q, k, v, lse, causal, window, cap, scale),
                ATTN_BWD_PASS_KERNELS, lambda: fa.bwd_routes()["wgmma"],
                args.reps)
        else:
            raise SystemExit(f"trace_loss_probe: unknown step {step!r}")
        steps.append({"step": step, "launched": rose,
                      "held": {name: len(us) for name, us in found.items()}})
    print(json.dumps({"ssd_case": label, "reps": args.reps,
                      "steps": steps}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
