"""The paper's measurement kernels on Hopper — the counterpart of
``repro.kernels.microbench`` (TPU kernels ``_stream_kernel`` and
``_madd_kernel``).

``stream_strided_cuda`` launches ``csrc/stream_strided.cu`` (the
block-stride memory stream) and ``madd_throughput_cuda`` launches
``csrc/madd_throughput.cu`` (the 8-chain FMA peak-FLOP kernel) on CUDA
tensors; the custom ops ``repro_torch::stream_strided`` and
``repro_torch::madd_throughput`` run the plain versions on CPU tensors
and give the counter their fake impls.  ``launches``
counts each kernel's launches by op name: a stream of more than
``ARRAYS_PER_LAUNCH`` inputs takes one launch per group of them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import madd_ref, stream_ref

#: launches of each CUDA kernel in this process
launches = {"stream_strided": 0, "madd_throughput": 0}

#: inputs one stream_strided launch sums (kArraysPerLaunch in the source)
ARRAYS_PER_LAUNCH = 8
_MAX_ELEMS = 2 ** 31 - 1   # the kernels index with 32-bit integers


@functools.lru_cache(maxsize=None)
def magic_divisor(d: int) -> Tuple[int, int]:
    """(magic, shift) with ``(n * magic) >> shift == n // d`` for every
    ``0 <= n < 2**31`` and ``1 <= d < 2**31``; ``magic`` fits 32 bits.
    The stream kernel finds an output index's block this way.

    shift = 31 + ceil(log2 d), magic = ceil(2^shift / d).  With
    e = magic·d − 2^shift (0 <= e < d), n·magic / 2^shift = n/d +
    n·e / (d·2^shift), and n·e < 2^31·2^ceil(log2 d) = 2^shift keeps the
    excess below 1/d, which cannot carry n/d past an integer."""
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


@torch.library.custom_op("repro_torch::stream_strided", mutates_args=(),
                         device_types="cpu")
def stream_strided(arrays: List[torch.Tensor], block: int,
                   stride: int) -> torch.Tensor:
    """n_arrays × [S] → [S / stride]: output block i sums the inputs'
    blocks i·stride."""
    return stream_ref(arrays, block=block, stride=stride)


def stream_strided_cuda(arrays: List[torch.Tensor], block: int,
                        stride: int) -> torch.Tensor:
    """Check the inputs, launch ``csrc/stream_strided.cu`` (one launch
    per group of ``ARRAYS_PER_LAUNCH`` inputs), count the launches."""
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
    out = first.new_empty(n_out * block)
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.data_ptr() for a in arrays])
    vec4 = block % 4 == 0 and all(
        p % 16 == 0 for p in (*ptrs, out.data_ptr()))
    magic, shift = magic_divisor(block // 4 if vec4 else block)
    _build.launch_on(first.device, "repro_stream_strided_f32", ptrs,
                     len(arrays), out.data_ptr(), n_out, block, stride,
                     int(vec4), magic, shift)
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


def madd_throughput_cuda(x: torch.Tensor, iters: int, block: int, a: float,
                         b: float) -> torch.Tensor:
    """Check the input, launch ``csrc/madd_throughput.cu``, count the
    launch."""
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
    _build.launch_on(x.device, "repro_madd_throughput_f32", x.data_ptr(),
                     out.data_ptr(), x.shape[0], iters, a, b)
    launches["madd_throughput"] += 1
    return out


@madd_throughput.register_fake
def _madd_throughput_fake(x, iters, block, a, b):
    return torch.empty_like(x)
