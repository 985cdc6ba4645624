#!/usr/bin/env python3
"""A one-off probe: what limits the bf16 attention backward's passes, on
one NVIDIA GPU.

    python3 tools/oneoff_attention_bwd_probe.py [--out build/attention_bwd_probe]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` as it is
and two variants of it, each into a library of its own under ``--out``
(one ``nvcc`` each, started together):

* ``no_probabilities``: the probability of a score is the score itself —
  no softcap's ex2 and rcp, no ex2(s − lse), the three MUFU operations an
  element gone — with every load, product and barrier kept;
* ``half_column_loads``: each column step loads only its D-wide tile (K
  in the Δ and dQ passes, Q in dK+dV), not its Dv-wide one (V, dO): half
  the bytes of the TMA ring, every product kept (on stale data).

The variants compute wrong gradients; they exist only to see what a
pass waits on.  They are made by replacing exact lines of the kernel's
source, so the probe stops (and says so) once those lines change: it
records one measurement of one design and is not kept in step with the
kernel.  Each library's Δ, dQ and dK+dV kernels are timed from a
``torch.profiler`` trace of 10 full backward calls (after 3 untraced),
at gemma2-9b's global layer and at yi-6b's G = 8 layer (bf16, S 4096,
causal), the libraries in turns: the kernel as it is, each variant, the
kernel again.  Prints one JSON line, then the card's name and power
limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (label, B, S, Hq, Hkv, D, softcap, q scale)
SHAPES = (("gemma2-9b global", 1, 4096, 16, 8, 256, 50.0, 8.0),
          ("yi-6b G=8", 1, 4096, 32, 4, 128, None, 1.0))
#: each pass's kernel by name (bwd_wg_query_kernel<MODE, NS>: 0 Δ, 1 dQ)
PASS_KERNELS = (("delta", "bwd_wg_query_kernel<0"),
                ("dq", "bwd_wg_query_kernel<1"),
                ("dkv", "bwd_wg_key_kernel"))


def variants(src: str) -> dict:
    """The kernel's source and each variant's, with every edit checked."""
    prob = """  if (p.softcap > 0.f) {
    x = fmaf(-2.f * sh.cap_l, rcp(1.f + ex2(x * sh.cap_k)), sh.cap_l);
    *t = x * sh.inv_cap_l;
  } else {
    x *= sh.scale_l;
    *t = 0.f;
  }
  return vis ? ex2(x - lse_l) : 0.f;"""
    expect = "mbar_arrive_expect_tx(sm.full(st), tile_bytes);"
    loads = ("      load_tile(sm.col_b(st), &mv, sm.full(st), nb, hk, c0, b);\n",
             "        load_tile(sm.col_b(st), &mo, sm.full(st), nb, hq, c0, b);\n")
    if src.count(prob) != 1 or src.count(expect) != 2 or \
            any(src.count(x) != 1 for x in loads):
        raise SystemExit("oneoff_attention_bwd_probe: the kernel's source no "
                         "longer has the lines the variants edit")
    half = src.replace(expect,
                       "mbar_arrive_expect_tx(sm.full(st), na * kSlabBytes);")
    for line in loads:
        half = half.replace(line, "")
    return {"kernel": src,
            "no_probabilities": src.replace(prob,
                                            "  *t = 0.f;\n  return x;"),
            "half_column_loads": half}


def build(out: Path) -> dict:
    """One shared library per variant; returns name → bf16 entry."""
    from repro_torch.kernels import _build
    srcs = variants((_build.CSRC / "flash_attention_bwd.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.HEADERS:
            (d / header).write_text((_build.CSRC / header).read_text())
        (d / "kernel.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
             "-o", str(d / "lib.so"), str(d / "kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out / name / "lib.so")) \
            .repro_flash_attention_bwd_bf16
        fn.argtypes = _build.SIGNATURES["repro_flash_attention_bwd_bf16"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "attention_bwd_probe"))
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("oneoff_attention_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    entries = build(Path(args.out))
    dev = torch.device("cuda")
    order = ["kernel", "no_probabilities", "half_column_loads", "kernel"]
    result = {}
    for label, B, S, Hq, Hkv, D, cap, qs in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(25)
        q = (torch.randn(B, S, Hq, D, generator=gen, device=dev) * qs).to(
            torch.bfloat16)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        dout = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(
            torch.bfloat16)
        scale = D ** -0.5
        _, lse = fa.flash_attention_lse_cuda(q, k, v, True, None, cap, scale)
        bufs = [torch.empty_like(t) for t in (q, k, v)] + [
            torch.empty(B, Hq, S, dtype=torch.float32, device=dev)]
        rows = {name: {} for name in entries}
        for turn, name in enumerate(order):
            fn = entries[name]

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         dout.data_ptr(), lse.data_ptr(), bufs[3].data_ptr(),
                         bufs[0].data_ptr(), bufs[1].data_ptr(),
                         bufs[2].data_ptr(), B, S, S, Hq, Hkv, D, D, scale,
                         0.0 if cap is None else cap, 1, -1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            us = dict.fromkeys((p for p, _ in PASS_KERNELS), 0.0)
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    for pname, key in PASS_KERNELS:
                        if key in ev.name:
                            us[pname] += ev.time_range.elapsed_us()
            ms = {pname: t / 10 / 1e3 for pname, t in us.items()}
            ms["all"] = sum(ms.values())
            suffix = "" if turn < 3 else "_again"
            rows[name].update({f"{p}{suffix}": t for p, t in ms.items()})
        result[label] = rows
        for name, row in rows.items():
            print(f"{label} {name}: " + ", ".join(
                f"{k} {v:.4g} ms" for k, v in row.items()), file=sys.stderr)
    print(json.dumps({"oneoff_attention_bwd_probe": result}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
