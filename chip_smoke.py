#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for sm_90a, print the seconds and the ptxas report, and hold
   the SASS (``cuobjdump -sass``) of ``madd_throughput``'s chain loop to
   8 FFMAs per step, so the compiler folded nothing;
2. hold every kernel against its plain PyTorch version on the card, at
   the reference test shapes (``tests/test_kernels.py`` tolerances) and
   at the main path's sizes, with TF32 off (float32 kernels against the
   plain version evaluated in float64);
3. calibrate the default battery on the card through
   ``python -m repro_torch.calibrate`` (3 trials, one CUDA-graph replay
   per timing) into a temporary profile;
4. predict the three §8 kernels from the reloaded profile — CLI
   ``predict`` at the reference target shapes, ``PerfSession`` at the
   real sizes — with zero timings;
5. time each of them at the real sizes (CUDA events) and print the base
   model's prediction against the measurement;
6. the model-zoo study: ``python -m repro_torch.calibrate --zoo`` on the
   card (the reference's ``STUDY_TAGS``, 18 kernels, 3 trials) and on the
   synthetic device ``apex``, then ``compare --sweep`` of the two;
7. predict all five kernels at real size from the card's zoo profile
   with each rung (zero timings), time them beside their plain versions,
   one library call and their bounds, and print predicted ÷ measured per
   kernel per rung;
8. print one ``{"kernels": [...]}`` line, the card's name and power
   limit, and the ``{"ok": true, "device": ...}`` line last.

Launch counters are set to 0 before phase 3 and read after phase 5 (the
three §8 kernels must have launched), and set to 0 again before phase 6
and read after phase 7 (all five must have launched).  Without a card
(or without the repository beside this file) it exits non-zero and
prints no result.
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

STREAM_SHAPES = [(8192, 256, stride, n_arrays) for stride in (1, 2, 4)
                 for n_arrays in (1, 3)]
MADD_SHAPE = (4096, 32, 1024)       # S, iters, block

# main-path sizes: each larger than the 50 MB L2
REAL_MATMUL = (4096, 4096, 4096)
REAL_STENCIL = (8192, 8192)
REAL_DG = (3, 64, 262144)
REAL_STREAM = (2 ** 26, 2, 512)     # S, n_arrays, block; strides 1 and 4
REAL_STREAM_STRIDES = (1, 4)
REAL_MADD = (2 ** 24, 256, 2048)    # S, iters, block
# f32 sums of 4096 products (elements ~64): the kernel's rounding alone
# reaches ~2e-4 absolute, above the reference's atol of 2e-5
REAL_MATMUL_TOL = dict(rtol=2e-4, atol=1e-3)
# 8 chains of 256 f32 steps: f32 cannot add b = 1e-7 to y ≈ 8 (half an
# ulp is 4.8e-7), so each output drops up to 8·256·b ≈ 2e-4 that the
# float64 plain version keeps, and each chain's 256 roundings add a few
# 1e-4 more — above the reference's atol of 2e-5 near zero outputs
REAL_MADD_TOL = dict(rtol=2e-4, atol=2e-3)
# the reference's a and b move each output by ~2e-4 of itself over 256
# steps, inside that tolerance: a kernel running half the chain, or none
# of it, would pass.  With these each step is visible (a^256 ≈ 0.77 and
# the chains head for b / (1 - a) = 10), while f32 rounding stays far
# inside the reference tolerance
MADD_VISIBLE = dict(a=0.999, b=0.01)
ZOO = ("lin_flop", "lin_flop_mem", "ovl_flop_mem")


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


def check_madd_rejects_short_chains(ref, x, iters) -> None:
    """The visible-step madd check must reject a kernel that runs half
    the chain or none of it: the plain version with ``iters // 2`` and 0
    steps has to fall outside the float32 tolerance on every element."""
    x = x.double()
    want = ref.madd_ref(x, iters=iters, **MADD_VISIBLE)
    room = TOL["float32"]["atol"] + TOL["float32"]["rtol"] * want.abs()
    for short in (iters // 2, 0):
        excess = (ref.madd_ref(x, iters=short, **MADD_VISIBLE)
                  - want).abs() / room
        inside = int((excess <= 1).sum())
        if inside:
            raise SystemExit(f"madd check: a kernel of {short} of {iters} "
                             f"steps would pass on {inside} elements")
        log(f"madd check: a kernel of {short} of {iters} steps fails on "
            f"every element, by at least {float(excess.min()):.3g}× the "
            f"tolerance")


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

    for size, block, stride, n_arrays in STREAM_SHAPES:
        arrs = [randn(rng, size).to(dev) for _ in range(n_arrays)]
        st = functools.partial(ops.stream_strided, block=block,
                               stride=stride)
        err = check(lambda *a: st(list(a)),
                    lambda *a: ref.stream_ref(list(a), block=block,
                                              stride=stride),
                    tuple(arrs), **TOL["float32"])
        log(f"stream_strided S={size} n_arrays={n_arrays} block {block} "
            f"stride {stride}: max|err| {err:.3g}")
    size, iters, block = MADD_SHAPE
    x = randn(rng, size).to(dev)
    for kw in ({}, MADD_VISIBLE):
        err = check(functools.partial(ops.madd_throughput, iters=iters,
                                      block=block, **kw),
                    functools.partial(ref.madd_ref, iters=iters, **kw),
                    (x,), **TOL["float32"])
        log(f"madd_throughput S={size} iters={iters} block {block} {kw}: "
            f"max|err| {err:.3g}")
    check_madd_rejects_short_chains(ref, x, iters)

    m, k, n = REAL_MATMUL
    mm_, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    stream_arrs = tuple(randn(rng, size).to(dev) for _ in range(n_arrays))
    madd_s, madd_iters, madd_block = REAL_MADD
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
        "madd_throughput": check(
            functools.partial(ops.madd_throughput, iters=madd_iters,
                              block=madd_block),
            functools.partial(ref.madd_ref, iters=madd_iters),
            (randn(rng, madd_s).to(dev),), **REAL_MADD_TOL),
    }
    madd_x = randn(rng, madd_s).to(dev)
    err = check(functools.partial(ops.madd_throughput, iters=madd_iters,
                                  block=madd_block, **MADD_VISIBLE),
                functools.partial(ref.madd_ref, iters=madd_iters,
                                  **MADD_VISIBLE),
                (madd_x,), **TOL["float32"])
    log(f"madd_throughput S={madd_s} iters={madd_iters} {MADD_VISIBLE}: "
        f"max|err| {err:.3g} ({TOL['float32']})")
    check_madd_rejects_short_chains(ref, madd_x, madd_iters)
    errs["stream_strided"] = max(
        check(lambda *a, s=stride: ops.stream_strided(list(a), block=block,
                                                      stride=s),
              lambda *a, s=stride: ref.stream_ref(list(a), block=block,
                                                  stride=s),
              stream_arrs, **TOL["float32"])
        for stride in REAL_STREAM_STRIDES)
    log(f"main-path sizes, max|err| vs plain: {errs} (matmul "
        f"{REAL_MATMUL_TOL}, madd_throughput {REAL_MADD_TOL}, others "
        f"{TOL['float32']})")
    return errs


def sass_counts(lib: Path) -> dict:
    """Per kernel function in the library's SASS (``cuobjdump -sass``):
    how many instructions of each opcode it holds, and each loop (a
    backward branch: ``[target, branch]`` addresses) with the opcodes
    inside it.  Empty when the toolkit has no ``cuobjdump``."""
    import re
    from repro_torch.kernels import _build
    opcodes = ("FFMA", "FADD")
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if fn is not None and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    result = {}
    for fn, instrs in funcs.items():
        def count(lo=0, hi=float("inf")):
            c = dict.fromkeys(opcodes, 0)
            for addr, text in instrs:
                words = text.replace(";", " ").split()
                for op in opcodes:
                    if lo <= addr <= hi and any(
                            w == op or w.startswith(op + ".") for w in words):
                        c[op] += 1
            return c
        loops = []
        for addr, text in instrs:
            b = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                loops.append({"loop": f"{lo:#x}-{addr:#x}",
                              **count(lo, addr)})
        result[fn] = {**count(), "loops": loops}
    return result


def check_madd_sass(sass: dict) -> None:
    """The microbench kernels' SASS counts; ``madd_kernel``'s innermost
    chain loop must issue 8 FFMAs per unrolled step (8 chains) and no
    FADD, so nothing of the chain was folded or reassociated."""
    for fn, found in sass.items():
        if "madd" in fn or "stream" in fn:
            log(f"sass {fn}: {found}")
    madd = [found for fn, found in sass.items() if "madd_kernel" in fn]
    if not madd:
        raise SystemExit("cuobjdump found no madd_kernel in the library")
    loops = [lp for lp in madd[0]["loops"] if lp["FFMA"]]
    inner = min(loops, key=lambda lp: lp["FFMA"] + lp["FADD"],
                default=None)
    if inner is None or inner["FFMA"] % 8 or inner["FADD"]:
        raise SystemExit(f"madd_kernel's chain loop is not 8 FFMAs per "
                         f"step: {madd[0]}")
    log(f"sass madd_kernel chain loop: {inner['FFMA']} FFMA = "
        f"{inner['FFMA'] // 8} steps × 8 chains per iteration")


def time_zoo_kernels(ops, ref, dev, preds_by_rung, F):
    """Phase 7's timing: every kernel at its real size, its plain
    version, one library call where there is one, and its bound; returns
    one JSON row per kernel (stream_strided carries its stride-4
    variant)."""
    import functools

    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    madd_s, madd_iters, madd_block = REAL_MADD
    lap = torch.tensor([[0., 1., 0.], [1., -4., 1.], [0., 1., 0.]],
                       device=dev)[None, None]
    stream_arrs = tuple(randn(rng, size).to(dev) for _ in range(n_arrays))

    def stream_case(stride):
        n_read = size // stride
        return dict(
            kernel=lambda *a: ops.stream_strided(list(a), block=block,
                                                 stride=stride),
            plain=lambda *a: ref.stream_ref(list(a), block=block,
                                            stride=stride),
            library=lambda x, y: torch.add(x.view(-1, block)[::stride],
                                           y.view(-1, block)[::stride]),
            args=stream_arrs,
            work=((n_arrays - 1) * n_read, 4 * (n_arrays + 1) * n_read))

    cases = {
        "matmul_tiled": dict(
            kernel=ops.matmul, plain=ref.matmul_ref, library=torch.matmul,
            args=(randn(rng, m, k).to(dev), randn(rng, k, n).to(dev)),
            work=(2 * m * n * k, 4 * (m * k + k * n + m * n))),
        "stencil5": dict(
            kernel=ops.stencil5, plain=ref.stencil5_ref,
            library=lambda x: F.conv2d(x[None, None], lap, padding=1),
            args=(randn(rng, *REAL_STENCIL).to(dev),),
            work=(5 * math.prod(REAL_STENCIL),
                  4 * 2 * math.prod(REAL_STENCIL))),
        "dg_diff": dict(
            kernel=ops.dg_diff, plain=ref.dg_diff_ref, library=torch.matmul,
            args=(randn(rng, mm, nn, nn).to(dev), randn(rng, nn, kk).to(dev)),
            work=(2 * mm * nn * nn * kk,
                  4 * (mm * nn * nn + nn * kk + mm * nn * kk))),
        "stream_strided": stream_case(1),
        "madd_throughput": dict(
            kernel=functools.partial(ops.madd_throughput, iters=madd_iters,
                                     block=madd_block),
            plain=functools.partial(ref.madd_ref, iters=madd_iters),
            library=None,
            args=(randn(rng, madd_s).to(dev),),
            # an FMA is two operations
            work=(16 * madd_iters * madd_s + 15 * madd_s, 8 * madd_s)),
    }
    cases["stream_strided"]["variant"] = ("stride4", stream_case(4))

    def measure(case, preds):
        ops_n, nbytes = case["work"]
        t_ops = ops_n / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        ms = time_ms(case["kernel"], *case["args"])
        lib = case["library"]
        return {
            "ms": ms,
            "plain_ms": time_ms(case["plain"], *case["args"]),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if lib is None else time_ms(lib,
                                                           *case["args"]),
            "predicted_ms": {r: p * 1e3 for r, p in preds.items()},
            "pred_over_meas": {r: p * 1e3 / ms for r, p in preds.items()},
        }

    rows = {}
    for name, case in cases.items():
        rows[name] = measure(case, preds_by_rung[name])
        if "variant" in case:
            tag, var = case["variant"]
            rows[name][tag] = measure(var, preds_by_rung[f"{name}_{tag}"])
    return rows


def zoo_path(calibrate_main, load_profile, PerfSession, f32, ops, tmp):
    """Phase 6-7's predictions: the zoo study on the card and on the
    synthetic device apex, ``compare --sweep``, and each kernel's
    real-size prediction from the card's profile with each rung.
    Returns {kernel: {rung: seconds}}."""
    import functools
    import torch
    h100 = tmp / "h100_zoo.json"
    apex = tmp / "apex_zoo.json"
    t0 = time.perf_counter()
    rc = calibrate_main(["--zoo", "--trials", "3", "--out", str(h100),
                         "--device", "cuda"])
    if rc != 0:
        raise SystemExit(f"zoo calibration exited {rc}")
    log(f"zoo study on the card took {time.perf_counter() - t0:.1f} s")
    if calibrate_main(["--zoo", "--synthetic", "apex", "--trials", "3",
                       "--out", str(apex)]) != 0:
        raise SystemExit("synthetic zoo calibration failed")
    profile = load_profile(h100)
    if profile.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise SystemExit(f"zoo profile fingerprint {profile.fingerprint}")
    if len(profile.kernel_names) != 18 or sorted(profile.fits) != \
            sorted(ZOO) or not len(profile.holdout):
        raise SystemExit(f"zoo profile: {len(profile.kernel_names)} "
                         f"kernels, fits {sorted(profile.fits)}")
    for name, mf in profile.fits.items():
        if not all(math.isfinite(v) for v in mf.params.values()):
            raise SystemExit(f"zoo fit {name} not finite: {mf.params}")
    if calibrate_main(["compare", str(h100), str(apex), "--sweep",
                       "--json", str(tmp / "compare.json")]) != 0:
        raise SystemExit("compare failed")

    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    madd_s, madd_iters, madd_block = REAL_MADD
    stream = [f32(size) for _ in range(n_arrays)]
    items = {
        "matmul_tiled": (ops.matmul, (f32(m, k), f32(k, n))),
        "stencil5": (ops.stencil5, (f32(*REAL_STENCIL),)),
        "dg_diff": (ops.dg_diff, (f32(mm, nn, nn), f32(nn, kk))),
        "stream_strided": (functools.partial(
            ops.stream_strided, block=block, stride=1), (stream,)),
        "stream_strided_stride4": (functools.partial(
            ops.stream_strided, block=block, stride=4), (stream,)),
        "madd_throughput": (functools.partial(
            ops.madd_throughput, iters=madd_iters, block=madd_block),
            (f32(madd_s),)),
    }
    session = PerfSession.open(h100)
    preds = {name: {} for name in items}
    for rung in ZOO:
        batch = session.predict_batch(list(items.values()), model=rung,
                                      names=list(items))
        for p in batch:
            if not (math.isfinite(p.seconds) and p.seconds > 0):
                raise SystemExit(f"{rung} prediction {p.kernel}: "
                                 f"{p.seconds}")
            preds[p.kernel][rung] = p.seconds
    if session.timer.calls != 0:
        raise SystemExit(f"zoo prediction timed {session.timer.calls} "
                         f"kernels")
    log(f"zoo prediction: {len(items)} kernels × {len(ZOO)} rungs, "
        f"timings_performed={session.timer.calls} "
        f"batched_evals={session.eval_calls}")
    return preds


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
    from repro_torch.kernels import _build, dg_diff, matmul_tiled
    from repro_torch.kernels import microbench, ops, ref, stencil5
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
            if any(w in line for w in ("registers", "spill", "==",
                                       "entry function")):
                log(f"ptxas {line.strip()}")
    check_madd_sass(sass_counts(lib))

    # ---- 2. each kernel against its plain version ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    errs = check_kernels(ops, ref, dev)

    def counts():
        return {"matmul_tiled": matmul_tiled.launches,
                "stencil5": stencil5.launches, "dg_diff": dg_diff.launches,
                **microbench.launches}

    def zero_counts():
        matmul_tiled.launches = stencil5.launches = dg_diff.launches = 0
        for name in microbench.launches:
            microbench.launches[name] = 0

    # ---- 3-5. the base-model path, counted ---------------------------------
    zero_counts()
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
    base_names = ("matmul_tiled", "stencil5", "dg_diff")
    preds = session.predict_batch(
        [(ops.matmul, (f32(m, k), f32(k, n))),
         (ops.stencil5, (f32(*REAL_STENCIL),)),
         (ops.dg_diff, (f32(mm, nn, nn), f32(nn, kk)))],
        names=list(base_names))
    if session.timer.calls != 0:
        raise SystemExit(f"prediction timed {session.timer.calls} kernels")
    for p in preds:
        if not (math.isfinite(p.seconds) and p.seconds > 0):
            raise SystemExit(f"prediction {p.kernel}: {p.seconds}")
        print(p.explain(top=3), flush=True)
    log(f"real-size prediction: timings_performed={session.timer.calls} "
        f"batched_evals={session.eval_calls}")

    rng = np.random.default_rng(11)
    args = {"matmul_tiled": (randn(rng, m, k).to(dev),
                             randn(rng, k, n).to(dev)),
            "stencil5": (randn(rng, *REAL_STENCIL).to(dev),),
            "dg_diff": (randn(rng, mm, nn, nn).to(dev),
                        randn(rng, nn, kk).to(dev))}
    wrappers = {"matmul_tiled": ops.matmul, "stencil5": ops.stencil5,
                "dg_diff": ops.dg_diff}
    base_ms = {name: time_ms(wrappers[name], *args[name])
               for name in base_names}
    launches = {name: counts()[name] for name in base_names}
    log(f"launches on the base-model path: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the base-model path never "
                         f"launched: {launches}")
    base_pred = {p.kernel: p.seconds * 1e3 for p in preds}
    for name in base_names:
        log(f"{name}: base model predicted {base_pred[name]:.4g} ms, "
            f"measured {base_ms[name]:.4g} ms (pred/meas "
            f"{base_pred[name] / base_ms[name]:.3g})")
    del args

    # ---- 6-7. the zoo-study path, counted -----------------------------------
    zero_counts()
    zoo_preds = zoo_path(calibrate_main, load_profile, PerfSession, f32,
                         ops, tmp)
    measured = time_zoo_kernels(ops, ref, dev, zoo_preds, F)
    launches = counts()
    log(f"launches on the zoo-study path: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the zoo-study path never launched: "
                         f"{launches}")

    sources = {"matmul_tiled": "src/repro/kernels/matmul_tiled.py:54",
               "stencil5": "src/repro/kernels/stencil5.py:43",
               "dg_diff": "src/repro/kernels/dg_diff.py:41",
               "stream_strided": "src/repro/kernels/microbench.py:44",
               "madd_throughput": "src/repro/kernels/microbench.py:80"}
    rows = []
    for name, meas in measured.items():
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": sources[name], "launches": launches[name],
               "max_abs_err": errs[name], **meas}
        if name in base_pred:
            row["predicted_ms"]["base"] = base_pred[name]
            row["pred_over_meas"]["base"] = base_pred[name] / meas["ms"]
        rows.append(row)
        for tag, r in [("", row)] + [(f" {t}", row[t]) for t in ("stride4",)
                                     if t in row]:
            ratios = " ".join(f"{rung} {v:.3g}"
                              for rung, v in r["pred_over_meas"].items())
            lib_ms = r["library_ms"]
            log(f"{name}{tag}: measured {r['ms']:.4g} ms, bound "
                f"{r['bound_ms']:.4g} ms by {r['bound_by']}, plain "
                f"{r['plain_ms']:.4g} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4g} ms'}; "
                f"pred/meas {ratios}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
