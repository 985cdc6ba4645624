#!/usr/bin/env python3
"""Where a served request's time goes, on one NVIDIA GPU.

    python3 tools/lm_serve_trace.py [--arch gemma2-9b] [--batch 2]
        [--prompt-len 4608] [--num-layers N]

The port's language model at the architecture's published config (or
cut to ``--num-layers``), random bf16 weights from seed 0, and the
frontend's inputs where it has one (internvl2's patch embeddings,
whisper's frames, in f32 as the serving launcher draws them).  Prefill: one
warm-up, then one between CUDA events and one under ``torch.profiler``.
Decode: after that prefill, three warm-up steps, then one step between
CUDA events and one under the profiler.  Every device kernel's time is
put in a class: the hand kernels (``flash_attention``, ``mamba2_ssd``'s
passes, ``slstm_cell``), the GEMMs of ``torch.matmul``, and the rest
(norms, RoPE, activations, the softcap, copies).  Each phase's time less
its kernels' sum is the device's idle time (host dispatch the card waits
for).  Prints one JSON line, then the card's name and power limit.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: substrings of device kernel names, by class (checked in this order)
CLASSES = (
    ("flash_attention", ("flash_wg_kernel", "flash_mma_kernel",
                         "flash_kernel")),
    ("mamba2_ssd", ("chunk_state_kernel", "state_pass_kernel",
                    "chunk_out_kernel")),
    ("slstm_cell", ("slstm_cluster_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "ampere_",
              "splitK")),
)


def kernel_class(name: str, classes=CLASSES) -> str:
    low = name.lower()
    for label, keys in classes:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def summary(prof, wall_ms: float, top: int, classes=CLASSES) -> dict:
    """A profiled phase's device kernels by class (``classes``: (label,
    name fragments) pairs, checked in order), its busiest kernels, and
    its idle time against ``wall_ms`` (the same phase between CUDA
    events, untraced)."""
    import torch
    per_kernel = defaultdict(lambda: {"calls": 0, "us": 0.0})
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = per_kernel[ev.name]
            k["calls"] += 1
            k["us"] += ev.time_range.elapsed_us()
    by_class = defaultdict(lambda: {"calls": 0, "ms": 0.0})
    for name, k in per_kernel.items():
        c = by_class[kernel_class(name, classes)]
        c["calls"] += k["calls"]
        c["ms"] += k["us"] / 1e3
    busy_ms = sum(c["ms"] for c in by_class.values())
    busiest = sorted(per_kernel.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {"ms": wall_ms, "kernels_ms": busy_ms,
            "idle_ms": wall_ms - busy_ms,
            "idle_share": (wall_ms - busy_ms) / wall_ms,
            "kernel_launches": sum(k["calls"] for k in per_kernel.values()),
            "by_class": dict(by_class),
            "top_kernels": [{"name": n[:120], "calls": k["calls"],
                             "ms": k["us"] / 1e3} for n, k in busiest]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4608)
    ap.add_argument("--num-layers", type=int, default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("lm_serve_trace: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import front_positions, make_request
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.num_layers is not None:
        cfg = cfg.replace(num_layers=args.num_layers)
    front = front_positions(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = lm.init(gen, cfg, dev)
        req = make_request(cfg, args.batch, args.prompt_len, gen, dev)

        def prefill():
            cache = lm.zero_cache(cfg, args.batch,
                                  front + args.prompt_len + 1, dev)
            return lm.prefill(params, cfg, cache, req)[1]

        prefill()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prefill()
        end.record()
        end.synchronize()
        wall_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prefill()
            torch.cuda.synchronize()
        prefill_trace = summary(prof, wall_ms, 25)

        # decode, after a prefill into a cache with room for the steps
        cache = lm.zero_cache(cfg, args.batch, front + args.prompt_len + 8,
                              dev)
        cache, logits = lm.prefill(params, cfg, cache, req)
        tok = logits.argmax(-1)
        pos = front + args.prompt_len

        def step():
            nonlocal cache, tok, pos
            cache, lg = lm.decode_step(params, cfg, cache, tok, pos)
            tok, pos = lg.argmax(-1), pos + 1

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        end.synchronize()
        decode_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        decode_trace = summary(prof, decode_ms, 10)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"lm_serve_trace": {
        "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
        "prompt_len": args.prompt_len, "prefill": prefill_trace,
        "decode_step": decode_trace, "device": smi}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
