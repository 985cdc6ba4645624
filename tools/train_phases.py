#!/usr/bin/env python3
"""``chip_smoke.py``'s training phases 16 (a) and 20 alone, in a fresh
process on one NVIDIA GPU.

    python3 tools/train_phases.py [--phases 16a,20] [--cases L1,L2]
        [--timed L1,L2] [--archs A,B] [--whole A,B] [--steps N] [--lr X]

Builds the kernels, then runs, as ``chip_smoke.py`` does: phase 16 (a)'s
attention backward checks (``check_attention_backward``: ``--cases`` of
``ATTN_BWD_CASES`` by label, then ``--timed`` of ``ATTN_BWD_TIMED``; by
default all of each, an empty list none) and phase 20
(``train_more_phase``: ``--archs`` of ``TRAIN_MORE`` trained ``--steps``
steps at peak rate ``--lr``, ``--whole`` of ``TRAIN_MORE_WHOLE`` card
against host; by default all, at the phase's steps and rate).  A fresh
process reads each model's peak memory without what earlier phases
leave allocated.  Prints the phases' JSON lines, then the card's name
and power limit.  Exits non-zero without a card or when a check fails.
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


def pick(rows, labels, name=lambda row: row):
    """The rows whose name is in the comma-separated ``labels`` (all of
    them where ``labels`` is None)."""
    if labels is None:
        return tuple(rows)
    keep = [x for x in labels.split(",") if x]
    return tuple(row for row in rows if name(row) in keep)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="16a,20")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--timed", default=None)
    ap.add_argument("--archs", default=None)
    ap.add_argument("--whole", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention, ops, ref

    dev = torch.device("cuda")
    phases = set(args.phases.split(","))
    t0 = time.perf_counter()
    lib = _build.build()
    cs.log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    cs.check_no_spills(_build.ptxas_report_path(lib).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "16a" in phases:
        cases = pick(zip(cs.ATTN_BWD_CASES, cs.ATTN_BWD_ROUTES), args.cases,
                     lambda row: row[0][0])
        t0 = time.perf_counter()
        backward = cs.check_attention_backward(
            ops, ref, flash_attention, dev,
            cases=tuple(c for c, _ in cases),
            routes=tuple(r for _, r in cases),
            timed=pick(cs.ATTN_BWD_TIMED, args.timed, lambda row: row[0]))
        cs.log(f"phase 16 (a) took {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"attention_backward": backward}), flush=True)
    if "20" in phases:
        counts, zero_counts = cs.launch_counters()
        tmp = Path(tempfile.mkdtemp(prefix="train_phases_"))
        out = cs.train_more_phase(
            counts, zero_counts, dev, tmp,
            archs=pick(cs.TRAIN_MORE, args.archs),
            whole=pick(cs.TRAIN_MORE_WHOLE, args.whole),
            steps=args.steps or cs.TRAIN_MORE_STEPS,
            lr=args.lr or cs.TRAIN_MORE_LR)
        cs.log(f"phase 20 took {out['seconds']:.1f} s")
        print(json.dumps({"train_archs": out}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
