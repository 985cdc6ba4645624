#!/usr/bin/env python3
"""Time ``dg_diff`` at the main path's size on one NVIDIA GPU, from the
``src/`` tree given (so two trees can be compared in one machine).

    python3 tools/dg_diff_widths.py [--src path/to/src] [--nodes 64 56]

For each node count N (M = 3, K = 262144, f32): the kernel in turns with
``torch.matmul`` on the same work (``chip_smoke.time_in_turns``: 5 rounds
of kernel, library, library, kernel) and its ``chip_smoke.time_ms``.  A
tree whose kernel does not take an N reports it as refused.  Prints one
JSON line, then the card's name and power limit.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
M, K = 3, 262144


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--nodes", type=int, nargs="+", default=[64, 56])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dg_diff_widths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import time_in_turns, time_ms
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    out = {"src": args.src, "nodes": {}}
    for n in args.nodes:
        d = torch.from_numpy(rng.standard_normal((M, n, n), np.float32)).to(dev)
        ut = torch.from_numpy(rng.standard_normal((n, K), np.float32)).to(dev)

        def library(d, ut):
            return torch.matmul(d, ut)

        try:
            ops.dg_diff(d, ut)
        except ValueError as e:
            out["nodes"][n] = {"refused": str(e)}
            continue
        turns = time_in_turns(ops.dg_diff, library, (d, ut))
        out["nodes"][n] = {"ms": time_ms(ops.dg_diff, d, ut),
                           "library_ms": time_ms(library, d, ut),
                           "in_turns_ratio": turns["median"],
                           "rounds": turns["rounds"]}
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
