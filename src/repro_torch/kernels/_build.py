"""Build the hand-written CUDA kernels into one shared library and bind
them with :mod:`ctypes`.

The sources under ``csrc/`` have a plain C interface (no PyTorch
headers), so ``nvcc`` compiles each in seconds.  The build runs at first
use, one ``nvcc`` per source started together, then one link, into
``build/repro_torch_kernels/`` at the repository root.  The library's
file name carries a hash of the sources and flags, so an edited source
builds afresh and a finished library is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch_on` raises when that is not 0, since a
refused launch (too many threads, too much shared memory) never runs and
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("matmul_tiled.cu", "stencil5.cu", "dg_diff.cu",
           "stream_strided.cu", "madd_throughput.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "mamba2_ssd.cu", "mamba2_ssd_bwd.cu",
           "slstm_cell.cu", "slstm_cell_bwd.cu")
#: headers the sources include (part of the library's hash)
HEADERS = ("mma_bf16.cuh", "wgmma_sm90.cuh", "ssd_common.cuh",
           "slstm_common.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
#: C entry point → argument types (pointers and the stream as c_void_p,
#: so ctypes never truncates a 64-bit address to an int)
SIGNATURES: Dict[str, List] = {
    # a, b, c, M, N, K
    "repro_matmul_tiled_f32": [_P, _P, _P, _I, _I, _I, _P],
    "repro_matmul_tiled_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "repro_stencil5_f32": [_P, _P, _I, _I, _I, _I, _P],
    # d, ut, out, M, N, K
    "repro_dg_diff_f32": [_P, _P, _P, _I, _I, _I, _P],
    # a host array of input pointers, n_arrays, out, n_out, block, stride,
    # vec4, then the output-block divisor's magic and shift
    "repro_stream_strided_f32": [ctypes.POINTER(_P), _I, _P, _I, _I, _I, _I,
                                 _U, _I, _P],
    "repro_madd_throughput_f32": [_P, _P, _I, _I, _F, _F, _P],
    # q, k, v, o, lse (or 0), B, Sq, Skv, Hq, Hkv, D, Dv, scale, softcap,
    # causal, window
    "repro_flash_attention_f32": [_P] * 5 + [_I] * 7 + [_F, _F, _I, _I, _P],
    "repro_flash_attention_bf16": [_P] * 5 + [_I] * 7 + [_F, _F, _I, _I, _P],
    # q, k, v, dout, lse, delta (scratch), dq, dk, dv, then as the forward
    # from B on
    "repro_flash_attention_bwd_f32": [_P] * 9 + [_I] * 7
    + [_F, _F, _I, _I, _P],
    "repro_flash_attention_bwd_bf16": [_P] * 9 + [_I] * 7
    + [_F, _F, _I, _I, _P],
    # host side, no stream: out[2], the bf16 backward's calls by route
    "repro_flash_attention_bwd_routes": [ctypes.POINTER(ctypes.c_longlong)],
    # the wgmma descriptor check: a, b, c, n, b read MN-major
    "repro_wgmma_tile_bf16": [_P, _P, _P, _I, _I, _P],
    # the SSD's passes: (a) xdt, da, B, states, decay; (b) states, decay,
    # final (the state after the last chunk, or 0);
    # (c) xdt, da, B, C, states, y; then batch, S, H, P, N, chunk
    "repro_ssd_chunk_state_f32": [_P] * 5 + [_I] * 6 + [_P],
    "repro_ssd_state_pass_f32": [_P] * 3 + [_I] * 6 + [_P],
    "repro_ssd_chunk_out_f32": [_P] * 6 + [_I] * 6 + [_P],
    # the SSD backward's passes: (a′) dy, da, C, grads; (b′) grads, decay;
    # (c′) xdt, da, B, C, dy, states, grads, dxdt, dda, dB, dC; then
    # batch, S, H, P, N, chunk
    "repro_ssd_chunk_state_grad_f32": [_P] * 4 + [_I] * 6 + [_P],
    "repro_ssd_state_grad_pass_f32": [_P] * 2 + [_I] * 6 + [_P],
    "repro_ssd_chunk_grad_f32": [_P] * 11 + [_I] * 6 + [_P],
    # g_in, r, b, y, state (c, n, m after the last step, or 0), traj (each
    # step's gates and c, n, m, or 0), batch, S, H, dh, cluster blocks,
    # batch rows per cluster (the plan's)
    "repro_slstm_cell_f32": [_P] * 6 + [_I] * 6 + [_P],
    # traj, r, dy, dgg, then as the forward from batch on
    "repro_slstm_cell_bwd_f32": [_P] * 4 + [_I] * 6 + [_P],
    # host side, no stream: batch, H, dh, cluster blocks, out[3]
    "repro_slstm_cell_plan": [_I] * 4 + [ctypes.POINTER(_I)],
    "repro_slstm_cell_bwd_plan": [_I] * 4 + [ctypes.POINTER(_I)],
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA toolkit is needed to build the kernels")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:12]}.so"


def ptxas_report_path(lib: Path) -> Path:
    """The compiler's ``-Xptxas=-v`` report (registers, shared memory,
    spills per kernel) of the library ``lib``, named by the same hash."""
    return lib.with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library,
    unless a library of these exact sources exists.  The ptxas report is
    written beside it (:func:`ptxas_report_path`) before the library
    appears."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = []
        for name, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [compiler, *NVCC_FLAGS, "-shared", *map(str, objs),
             "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        ptxas_report_path(lib).write_text("\n".join(logs))
        os.replace(staged, lib)   # atomic: concurrent builders never tear
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_on(device, name: str, *args, stream: bool = True) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (passed
    as the last argument; none with ``stream=False``, for a host-side
    entry point) and raise if it reported an error.  ``device`` is made
    current only when it is not.

    The stream comes from ``torch._C._cuda_getCurrentRawStream``, a
    private call (checked against torch 2.11.0+cu128; the card test
    ``test_raw_stream_is_the_current_stream`` holds it to the public
    ``torch.cuda.current_stream(device).cuda_stream``), which builds no
    ``torch.cuda.Stream`` object: host time a call that a card waiting on
    its next kernel would otherwise spend idle."""
    lib = library()
    if stream:
        args = (*args, torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = getattr(lib, name)(*args)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
