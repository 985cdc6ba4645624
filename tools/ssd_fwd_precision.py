#!/usr/bin/env python3
"""The SSD forward against the reference's elementwise f32 tolerance, on
one NVIDIA GPU, from the ``src/`` tree given (so two trees compare in
one machine).

    python3 tools/ssd_fwd_precision.py [--src path/to/src] [--seed 60]

For each shape of ``tests/test_torch_gpu.py``'s unaligned-operand cases
and zamba2-7b's layer (B 1, S 4096, H 112, P = N = 64, chunk 256), with
the tests' inputs (numpy seeds ``--seed`` to ``--seed`` + 3, the tests'
60–63 by default: x, −0.1·|randn| for dt·A, B, C):
``ops.mamba2_ssd`` on the card against ``ref.ssd_ref`` on float64 copies,
the worst |err| / (2e-5 + 2e-4·|want|) (``tests/test_kernels.py:17``), its
element (b, t, h, p), and how many elements miss.  Then the forward's
time at S 8192 (``chip_smoke.time_ms``, as ``tools/ssd_bwd_split.py``),
and pass (c)'s registers and spills from the build's ptxas report.
Prints one JSON line, then the card's name and power limit.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CASES = ((1, 256, 2, 64, 64, 256), (2, 128, 3, 32, 16, 64),
         (1, 96, 2, 20, 12, 48), (1, 4096, 112, 64, 64, 256))
FORWARD = (1, 8192, 112, 64, 64, 256)


def rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to run")
    ap.add_argument("--seed", type=int, default=60,
                    help="the first of the four numpy seeds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_fwd_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import ptxas_report, ssd_inputs, time_ms
    from repro_torch.kernels import _build, mamba2_ssd, ops, ref

    dev = torch.device("cuda")
    lib = _build.build()
    out = {"src": args.src, "seeds": [args.seed + i for i in range(4)],
           "cases": [], "ptxas_chunk_out": {
               fn: list(r) for fn, r in ptxas_report(
                   _build.ptxas_report_path(lib).read_text()).items()
               if "chunk_out_kernel" in fn}}
    for B, S, H, P, N, chunk in CASES:
        ops_in = [torch.from_numpy(a).to(dev) for a in (
            rn(args.seed, B, S, H, P),
            -np.abs(rn(args.seed + 1, B, S, H)) * 0.1,
            rn(args.seed + 2, B, S, H, N), rn(args.seed + 3, B, S, H, N))]
        got = ops.mamba2_ssd(*ops_in, chunk=chunk).double()
        want = ref.ssd_ref(*(t.double() for t in ops_in))
        ratio = (got - want).abs() / (2e-5 + 2e-4 * want.abs())
        worst = int(ratio.argmax())
        at = np.unravel_index(worst, tuple(ratio.shape))
        out["cases"].append({
            "shape": [B, S, H, P, N, chunk],
            "worst_err_over_tol": float(ratio.max()),
            "at_b_t_h_p": [int(i) for i in at],
            "err": float((got - want).abs().flatten()[worst]),
            "want": float(want.flatten()[worst]),
            "missing": int((ratio > 1).sum())})
    gen = torch.Generator(device=dev).manual_seed(17)
    B, S, H, P, N, chunk = FORWARD
    x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
    out["forward_ms"] = time_ms(mamba2_ssd.mamba2_ssd_cuda, x, da, bm, cm,
                                chunk, iters=50)
    out["forward_shape"] = list(FORWARD)
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
