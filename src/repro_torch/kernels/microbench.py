"""The paper's measurement kernels on Hopper — the counterpart of
``repro.kernels.microbench`` (TPU kernels ``_stream_kernel`` and
``_madd_kernel``).

``repro_torch::stream_strided`` launches ``csrc/stream_strided.cu`` (the
block-stride memory stream) and ``repro_torch::madd_throughput``
launches ``csrc/madd_throughput.cu`` (the 8-chain FMA peak-FLOP kernel)
for CUDA tensors; CPU tensors run the plain versions.  ``launches``
counts each kernel's launches by op name: a stream of more than
``ARRAYS_PER_LAUNCH`` inputs takes one launch per group of them.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import madd_ref, stream_ref

#: launches of each CUDA kernel in this process
launches = {"stream_strided": 0, "madd_throughput": 0}

#: inputs one stream_strided launch sums (kArraysPerLaunch in the source)
ARRAYS_PER_LAUNCH = 8
_MAX_ELEMS = 2 ** 31 - 1   # the kernels index with 32-bit integers


@torch.library.custom_op("repro_torch::stream_strided", mutates_args=(),
                         device_types="cpu")
def stream_strided(arrays: List[torch.Tensor], block: int,
                   stride: int) -> torch.Tensor:
    """n_arrays × [S] → [S / stride]: output block i sums the inputs'
    blocks i·stride."""
    return stream_ref(arrays, block=block, stride=stride)


@stream_strided.register_kernel("cuda")
def _stream_strided_cuda(arrays, block, stride):
    first = arrays[0]
    (s,) = first.shape
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"stream_strided takes float32, got {a.dtype}")
        if a.shape != first.shape or a.device != first.device:
            raise ValueError("stream_strided inputs must share one shape "
                             "and one device")
        if not a.is_contiguous():
            raise ValueError("stream_strided takes contiguous inputs")
    if s > _MAX_ELEMS:
        raise ValueError(f"stream_strided kernel indexes with 32 bits; "
                         f"{s} elements is too many")
    n_out = s // (block * stride)
    out = torch.empty(n_out * block, dtype=first.dtype, device=first.device)
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.data_ptr() for a in arrays])
    vec4 = block % 4 == 0 and all(
        p % 16 == 0 for p in (*ptrs, out.data_ptr()))
    with torch.cuda.device(first.device):
        _build.launch("repro_stream_strided_f32", ptrs, len(arrays),
                      out.data_ptr(), n_out, block, stride, int(vec4),
                      torch.cuda.current_stream().cuda_stream)
    launches["stream_strided"] += -(-len(arrays) // ARRAYS_PER_LAUNCH)
    return out


@stream_strided.register_fake
def _stream_strided_fake(arrays, block, stride):
    n_out = arrays[0].shape[0] // (block * stride)
    return arrays[0].new_empty((n_out * block,))


@torch.library.custom_op("repro_torch::madd_throughput", mutates_args=(),
                         device_types="cpu")
def madd_throughput(x: torch.Tensor, iters: int, block: int, a: float,
                    b: float) -> torch.Tensor:
    """x[S] → [S]: 8 chains of ``y·a + b``, ``iters`` deep, summed."""
    return madd_ref(x, iters=iters, a=a, b=b)


@madd_throughput.register_kernel("cuda")
def _madd_throughput_cuda(x, iters, block, a, b):
    if x.dtype != torch.float32:
        raise TypeError(f"madd_throughput takes float32, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] % block:
        raise ValueError(f"madd_throughput: {tuple(x.shape)} does not "
                         f"tile by block={block}")
    if not x.is_contiguous():
        raise ValueError("madd_throughput takes a contiguous input")
    if x.shape[0] > _MAX_ELEMS:
        raise ValueError(f"madd_throughput kernel indexes with 32 bits; "
                         f"{x.shape[0]} elements is too many")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch("repro_madd_throughput_f32", x.data_ptr(),
                      out.data_ptr(), x.shape[0], iters, a, b,
                      torch.cuda.current_stream().cuda_stream)
    launches["madd_throughput"] += 1
    return out


@madd_throughput.register_fake
def _madd_throughput_fake(x, iters, block, a, b):
    return torch.empty_like(x)
