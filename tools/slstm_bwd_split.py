#!/usr/bin/env python3
"""The sLSTM backward's times on one NVIDIA GPU, from the ``src/`` tree
given (so two trees compare in one machine, in turns).

    python3 tools/slstm_bwd_split.py [--src path/to/src] [--reps 10]

At xlstm-125m's sLSTM layer (B 8, S 4096, H 4, dh 192, f32), each with
``chip_smoke.time_ms`` (median of 10 between CUDA events):

* the three gradients as ``SLSTMCell.backward`` computes them
  (``slstm_cell_bwd_cuda``: dg_in, dR and db), the backward kernel's own
  device time in that call (``chip_smoke.pass_ms``, a ``torch.profiler``
  trace of ``--reps`` calls), and the peak memory the call adds;
* dg_in alone (``slstm_cell_dgg_cuda``);
* the backward's step-latency floor: the three gradients and dg_in alone
  at B 1, H 1, dh 4 and the same S, where the products vanish and S ×
  (gating, exchange) is left;
* the forward (``slstm_cell_cuda``) and its step floor at the same
  shapes.

Prints one JSON line, then the card's name and power limit.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8, 4096, 4, 192)   # B, S, H, dh
FLOOR = (1, 4096, 1, 4)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slstm_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import pass_ms, slstm_inputs, time_ms
    from repro_torch.kernels import slstm_cell as sc

    dev = torch.device("cuda")
    out = {"src": args.src, "shape": list(SHAPE), "floor_shape": list(FLOOR)}
    for tag, (B, S, H, dh) in (("", SHAPE), ("floor_", FLOOR)):
        gen = torch.Generator(device=dev).manual_seed(17)
        g_in, r, b = slstm_inputs(gen, dev, B, S, H, dh)
        dy = torch.randn(B, S, H, dh, generator=gen, device=dev)
        h, traj = sc.slstm_cell_traj_cuda(g_in, r, b)

        def grads():
            return sc.slstm_cell_bwd_cuda(traj, h, r, dy)

        out[f"{tag}grads_ms"] = time_ms(grads)
        out[f"{tag}dgg_ms"] = time_ms(sc.slstm_cell_dgg_cuda, traj, r, dy)
        out[f"{tag}forward_ms"] = time_ms(sc.slstm_cell_cuda, g_in, r, b)
        if not tag:
            out["kernel_device_ms"] = pass_ms(
                grads, (("bwd", "slstm_bwd_cluster_kernel"),),
                "sLSTM backward", lambda: sc.backward_launches,
                args.reps)["bwd"]
            out["plan"] = sc.bwd_plans[(g_in.device, B, H, dh)]
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads()
            torch.cuda.synchronize()
            out["peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
        del g_in, r, b, dy, h, traj
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
