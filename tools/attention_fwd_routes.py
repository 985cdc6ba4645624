#!/usr/bin/env python3
"""The attention forward's bf16 routes on one NVIDIA GPU: the wgmma route
(the main path's) beside the mma.sync route it replaced and
``flex_attention``, at the main path's layers.

    python3 tools/attention_fwd_routes.py

``chip_smoke.attention_in_turns`` (phase 9's check and timing) at
its layers (``chip_smoke.TURNS_LAYERS``): gemma2-9b's local and global
(B 1, S 8192, 16 / 8 heads × 256, softcap 50, the local with window
4096), zamba2-7b's (B 1, S 8192, 32 / 32 × 112, causal), and the served
yi-6b, deepseek-v2-236b MLA and whisper-tiny f32 encoder layers (the
last on the FMA route, beside ``flex_attention`` only): each route held
against the plain version, its
ms, the tensor bound, the MUFU floor, and the wgmma route in turns with
the mma.sync route and with ``flex_attention``; then a split of the
wgmma route's time at gemma2-9b's layers: the same call without the
softcap (one MUFU operation a score instead of three), without the
window, and on the first 128 of the 256 columns of q, k and v (half the
products' work, the same softmax work).  The kernels' own checks are the
card tests' and ``chip_smoke.py``'s.

Prints one JSON line, then the card's name and power limit.  Exits
non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("attention_fwd_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (attention_in_turns, attn_inputs,
                            model_layer_sizes, time_ms)
    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa

    def log(msg):
        print(f"[attention_fwd_routes] {msg}", flush=True)

    dev = torch.device("cuda")
    sizes = model_layer_sizes(configs)
    out = {"layers": attention_in_turns(fa, ref, sizes, dev)}
    gen = torch.Generator(device=dev).manual_seed(11)
    a = sizes["attention"]
    for layer in ("local", "global"):
        kw = sizes[layer]
        q, k, v = attn_inputs(gen, dev, torch.bfloat16, **a)
        wg = functools.partial(fa.flash_attention_cuda, block_q=128,
                               block_k=64, causal=kw["causal"],
                               window=kw.get("window"),
                               softcap=kw.get("softcap"),
                               scale=a["D"] ** -0.5)
        row = out["layers"][layer]
        for tag, change in (("no_softcap", dict(softcap=None)),
                            ("no_window", dict(window=None))):
            if kw.get(tag[3:]) is not None:
                row[f"{tag}_ms"] = time_ms(functools.partial(wg, **change),
                                           q, k, v)
        # half the products' work, the same MUFU work
        row["d128_ms"] = time_ms(wg, *(t[..., :128].contiguous()
                                       for t in (q, k, v)))
        log(f"{layer} split: " + ", ".join(
            f"{tag} {row[f'{tag}_ms']:.4g} ms"
            for tag in ("no_softcap", "no_window", "d128")
            if f"{tag}_ms" in row) + f" (the call {row['ms']:.4g} ms)")
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
