#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for sm_90a and print the seconds and the ptxas report;
2. hold every kernel against its plain PyTorch version on the card, at
   the reference test shapes (``tests/test_kernels.py`` tolerances) and
   at the main path's sizes, with TF32 off (float32 kernels against the
   plain version evaluated in float64);
3. calibrate the default battery on the card through
   ``python -m repro_torch.calibrate`` (3 trials) into a temporary
   profile;
4. predict the three §8 kernels from the reloaded profile — CLI
   ``predict`` at the reference target shapes, ``PerfSession`` at the
   real sizes — with zero timings;
5. time each kernel at the real sizes (CUDA events) beside its plain
   version, one library call and its bound, and print predicted against
   measured;
6. print one ``{"kernels": [...]}`` line, the card's name and power
   limit, and the ``{"ok": true, "device": ...}`` line last.

Launch counters are set to 0 before phase 3 and read after phase 5:
every kernel must have launched on the main path.  Without a card (or
without the repository beside this file) it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# reference test shapes (tests/test_kernels.py) and tolerances
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MATMUL_SHAPES = [(128, 128, 128, 128, 128, 128),
                 (256, 128, 512, 128, 128, 64),
                 (512, 512, 256, 256, 128, 256)]
STENCIL_SHAPES = [(256, 256, 128, 128), (256, 512, 256, 256),
                  (128, 128, 64, 128)]
DG_SHAPES = [(3, 64, 1024, 256), (1, 32, 512, 512)]

# main-path sizes: each larger than the 50 MB L2
REAL_MATMUL = (4096, 4096, 4096)
REAL_STENCIL = (8192, 8192)
REAL_DG = (3, 64, 262144)
# f32 sums of 4096 products (elements ~64): the kernel's rounding alone
# reaches ~2e-4 absolute, above the reference's atol of 2e-5
REAL_MATMUL_TOL = dict(rtol=2e-4, atol=1e-3)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def randn(rng, *shape):
    import torch
    return torch.from_numpy(rng.standard_normal(shape).astype("float32"))


def time_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median device milliseconds of one call, CUDA events around each."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def check(kernel, plain, args, **tol) -> float:
    """Assert the kernel's result is allclose to the plain version's on
    the same inputs; return the max absolute error.  Float32 kernels are
    held against the plain version evaluated on float64 copies, so the
    error measured is the kernel's own and not the difference of two f32
    summation orders; bf16 against the plain version in bf16."""
    import numpy as np
    import torch
    got = kernel(*args)
    if got.dtype == torch.float32:
        args = tuple(x.double() for x in args)
    want = plain(*args)
    torch.cuda.synchronize()
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    np.testing.assert_allclose(g, w, **tol)
    return float(np.max(np.abs(g - w)))


def check_kernels(ops, ref, dev) -> dict:
    """Phase 2: every kernel against its plain version; returns the max
    absolute error at the main path's sizes per kernel."""
    import functools

    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    for m, k, n, bm, bn, bk in MATMUL_SHAPES:
        for dt, tdt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            a = randn(rng, m, k).to(dev, tdt)
            b = randn(rng, k, n).to(dev, tdt)
            mm = functools.partial(ops.matmul, block_m=bm, block_n=bn,
                                   block_k=bk)
            err = check(mm, ref.matmul_ref, (a, b), **TOL[dt])
            log(f"matmul_tiled {dt} {(m, k, n)} blocks {(bm, bn, bk)}: "
                f"max|err| {err:.3g} (rtol {TOL[dt]['rtol']}, "
                f"atol {TOL[dt]['atol']})")
    for m, n, bm, bn in STENCIL_SHAPES:
        u = randn(rng, m, n).to(dev)
        st = functools.partial(ops.stencil5, block_m=bm, block_n=bn)
        err = check(st, ref.stencil5_ref, (u,), **TOL["float32"])
        log(f"stencil5 {(m, n)} blocks {(bm, bn)}: max|err| {err:.3g}")
    for mm_, nn, kk, be in DG_SHAPES:
        d, ut = randn(rng, mm_, nn, nn).to(dev), randn(rng, nn, kk).to(dev)
        dg = functools.partial(ops.dg_diff, block_e=be)
        err = check(dg, ref.dg_diff_ref, (d, ut), **TOL["float32"])
        log(f"dg_diff {(mm_, nn, kk)} block_e {be}: max|err| {err:.3g}")

    m, k, n = REAL_MATMUL
    mm_, nn, kk = REAL_DG
    errs = {
        "matmul_tiled": check(
            ops.matmul, ref.matmul_ref,
            (randn(rng, m, k).to(dev), randn(rng, k, n).to(dev)),
            **REAL_MATMUL_TOL),
        "stencil5": check(ops.stencil5, ref.stencil5_ref,
                          (randn(rng, *REAL_STENCIL).to(dev),),
                          **TOL["float32"]),
        "dg_diff": check(ops.dg_diff, ref.dg_diff_ref,
                         (randn(rng, mm_, nn, nn).to(dev),
                          randn(rng, nn, kk).to(dev)), **TOL["float32"]),
    }
    log(f"main-path sizes, max|err| vs plain: {errs} (matmul "
        f"{REAL_MATMUL_TOL}, others {TOL['float32']})")
    return errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.analysis.targets import f32
    from repro_torch.api import PerfSession
    from repro_torch.kernels import _build, dg_diff, matmul_tiled, ops, ref
    from repro_torch.kernels import stencil5
    from repro_torch.profiles import load_profile
    from repro_torch.profiles.cli import main as calibrate_main

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} ({smi})")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = _build.BUILD_DIR / "ptxas.txt"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"ptxas {line.strip()}")

    # ---- 2. each kernel against its plain version ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    errs = check_kernels(ops, ref, dev)

    # ---- 3-5. the main path, counted --------------------------------------
    modules = {"matmul_tiled": matmul_tiled, "stencil5": stencil5,
               "dg_diff": dg_diff}
    for mod in modules.values():
        mod.launches = 0

    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_"))
    profile_path = tmp / "h100_profile.json"
    t0 = time.perf_counter()
    rc = calibrate_main(["--out", str(profile_path), "--trials", "3",
                         "--device", "cuda"])
    if rc != 0:
        raise SystemExit(f"calibration exited {rc}")
    log(f"calibration took {time.perf_counter() - t0:.1f} s")
    profile = load_profile(profile_path)
    fit = profile.fits["base"].fit
    if profile.fingerprint.platform != "gpu" or \
            profile.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise SystemExit(f"profile fingerprint {profile.fingerprint}")
    if len(profile.kernel_names) != 43:
        raise SystemExit(f"battery has {len(profile.kernel_names)} kernels, "
                         f"the reference selects 43")
    if not all(math.isfinite(v) and v >= 0 for v in fit.params.values()):
        raise SystemExit(f"fitted params not finite/nonnegative: {fit}")
    log(f"profile {profile.fingerprint.id}: converged={fit.converged} "
        f"residual={fit.residual_norm:.6g} params={fit.params}")

    rc = calibrate_main(["predict", str(profile_path),
                         "--kernel", "kernels.ops.matmul",
                         "--kernel", "kernels.ops.stencil5",
                         "--kernel", "kernels.ops.dg_diff",
                         "--explain", "3", "--expect-zero-timings"])
    if rc != 0:
        raise SystemExit(f"predict exited {rc}")

    session = PerfSession.open(profile_path)
    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    preds = session.predict_batch(
        [(ops.matmul, (f32(m, k), f32(k, n))),
         (ops.stencil5, (f32(*REAL_STENCIL),)),
         (ops.dg_diff, (f32(mm, nn, nn), f32(nn, kk)))],
        names=list(modules))
    if session.timer.calls != 0:
        raise SystemExit(f"prediction timed {session.timer.calls} kernels")
    for p in preds:
        if not (math.isfinite(p.seconds) and p.seconds > 0):
            raise SystemExit(f"prediction {p.kernel}: {p.seconds}")
        print(p.explain(top=3), flush=True)
    log(f"real-size prediction: timings_performed={session.timer.calls} "
        f"batched_evals={session.eval_calls}")

    rng = np.random.default_rng(11)
    a, b = randn(rng, m, k).to(dev), randn(rng, k, n).to(dev)
    u = randn(rng, *REAL_STENCIL).to(dev)
    d, ut = randn(rng, mm, nn, nn).to(dev), randn(rng, nn, kk).to(dev)
    args = {"matmul_tiled": (a, b), "stencil5": (u,), "dg_diff": (d, ut)}
    wrappers = {"matmul_tiled": ops.matmul, "stencil5": ops.stencil5,
                "dg_diff": ops.dg_diff}
    ms = {name: time_ms(wrappers[name], *args[name]) for name in modules}
    launches = {name: mod.launches for name, mod in modules.items()}
    log(f"launches on the main path: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")

    # ---- yardsticks: plain version, one library call, the bound ----------
    lap = torch.tensor([[0., 1., 0.], [1., -4., 1.], [0., 1., 0.]],
                       device=dev)[None, None]
    plain = {"matmul_tiled": ref.matmul_ref, "stencil5": ref.stencil5_ref,
             "dg_diff": ref.dg_diff_ref}
    library = {
        "matmul_tiled": torch.matmul,
        "stencil5": lambda x: F.conv2d(x[None, None], lap, padding=1),
        "dg_diff": torch.matmul,
    }
    work = {   # (operations, bytes moved: inputs once, output once)
        "matmul_tiled": (2 * m * n * k, 4 * (m * k + k * n + m * n)),
        "stencil5": (5 * math.prod(REAL_STENCIL),
                     4 * 2 * math.prod(REAL_STENCIL)),
        "dg_diff": (2 * mm * nn * nn * kk,
                    4 * (mm * nn * nn + nn * kk + mm * nn * kk)),
    }
    sources = {"matmul_tiled": "src/repro/kernels/matmul_tiled.py:54",
               "stencil5": "src/repro/kernels/stencil5.py:43",
               "dg_diff": "src/repro/kernels/dg_diff.py:41"}
    rows = []
    for (name, mod), p in zip(modules.items(), preds):
        ops_n, nbytes = work[name]
        t_ops = ops_n / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        plain_ms = time_ms(plain[name], *args[name])
        library_ms = time_ms(library[name], *args[name])
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "predicted_ms": p.seconds * 1e3,
        }
        rows.append(row)
        log(f"{name}: predicted {row['predicted_ms']:.4g} ms, measured "
            f"{row['ms']:.4g} ms (pred/meas {row['predicted_ms'] / row['ms']:.3g}), "
            f"bound {row['bound_ms']:.4g} ms by {row['bound_by']}, plain "
            f"{plain_ms:.4g} ms, library {library_ms:.4g} ms")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
