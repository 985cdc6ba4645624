#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 alone, on one NVIDIA GPU.

    python3 tools/roofline_probe.py [--steps 3] [--out DIR]

Builds the kernels, starts phase 18 (d)'s two dry-runs, trains
``--steps`` steps of gemma2-9b (phase 16 (b)'s cut) and zamba2-7b and
xlstm-125m (phase 17 (b)'s) to measure them, then runs phase 19 itself
(:func:`chip_smoke.roofline_phase`): the walk check, one walked step of
each model, the dry-run records priced and benched.  Every check of
phase 19 is fatal here too.  Writes ``roofline.json`` and the two
dry-run cells' ``*.ops.json`` under ``--out`` (default ``chiprun_out``);
prints the card's name and power limit first.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("roofline_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.configs import InputShape, OptimizerConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.presets import make_run_config
    from repro_torch.models import counting
    from repro_torch.models.param import tree_leaves
    from repro_torch.runtime import Trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"torch {torch.__version__}; {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    counts, zero_counts = cs.launch_counters()
    tmp = Path(tempfile.mkdtemp(prefix="roofline_probe_"))
    started = cs.start_dryruns(tmp)
    try:
        measured = {}
        for arch in (cs.TRAIN_ARCH, *cs.RECURRENT_TRAIN):
            measured[arch] = cs.train_path(
                Trainer, make_run_config, InputShape, OptimizerConfig,
                configs, counting, tree_leaves, counts, zero_counts, dev,
                tmp, arch=arch, steps=args.steps,
                launches=cs.trained_launches(configs, arch))["steps"]
        cells = cs.collect_dryruns(started, tmp)
    finally:
        for _, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    roofline = cs.roofline_phase(counts, zero_counts, measured, cells, tmp,
                                 dev, smi)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline.json").write_text(json.dumps(roofline))
    for key in cells:
        name = f"{key}.ops.json"
        (out / name).write_text((cs.dryrun_dir(tmp) / name).read_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
