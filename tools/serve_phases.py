#!/usr/bin/env python3
"""``chip_smoke.py``'s serving phases alone, in a fresh process on one
NVIDIA GPU.

    python3 tools/serve_phases.py [--phases 2,9,15] [--archs A,B]
        [--layers yi,mla,whisper_enc]

Builds the kernels, then runs, as ``chip_smoke.py`` does: phase 2's
model-layer kernel checks (``check_model_kernels``: the reference's
cases, the served shapes of ``variants.ATTN_SERVED_CASES``, the real
sizes), phase 9's attention layers in turns (``attention_in_turns``,
``--layers`` of ``TURNS_LAYERS``, by default the served ones phases
2–8 do not time) and phase 15 (``lm_path``: ``--archs`` of
``LM_SERVED``, by default all ten).  A fresh process reads the init's
peak memory without what earlier phases leave allocated.  Prints the
phases' JSON lines, then the card's name and power limit.  Exits
non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="2,9,15")
    ap.add_argument("--archs", default=None)
    ap.add_argument("--layers", default="yi,mla,whisper_enc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.configs import InputShape
    from repro_torch.kernels import _build, flash_attention, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import counting, lm
    from repro_torch.models.param import tree_map
    from repro_torch.testing import variants

    dev = torch.device("cuda")
    phases = set(args.phases.split(","))
    t0 = time.perf_counter()
    lib = _build.build()
    cs.log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    cs.check_no_spills(_build.ptxas_report_path(lib).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = cs.model_layer_sizes(configs)
    if "2" in phases:
        t0 = time.perf_counter()
        cs.check_model_kernels(ops, ref, variants, dev, sizes)
        cs.log(f"phase 2's model-layer kernels took "
               f"{time.perf_counter() - t0:.1f} s")
    if "9" in phases:
        layers = args.layers.split(",")
        cs.TURNS_LAYERS = tuple(t for t in cs.TURNS_LAYERS
                                if t[0] in layers)
        turns = cs.attention_in_turns(flash_attention, ref, sizes, dev)
        print(json.dumps({"turns": turns}), flush=True)
    if "15" in phases:
        if args.archs:
            cs.LM_SERVED = tuple(r for r in cs.LM_SERVED
                                 if r[0] in args.archs.split(","))
        _, zero_counts = cs.launch_counters()
        t0 = time.perf_counter()
        served = cs.lm_path(
            serve.main, lm, counting, InputShape, tree_map, configs, ops,
            ref, serve.launch_counts, zero_counts, dev,
            prefill_launches=serve.prefill_launches,
            route=flash_attention.route)
        cs.log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"lm": served}), flush=True)
    if torch.distributed.is_initialized():   # the launcher's 1 × 1 mesh
        torch.distributed.destroy_process_group()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
