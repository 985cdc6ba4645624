"""Public wrappers around the hand-written kernels — the counterpart of
``repro.kernels.ops``, with the reference's keyword names and block
defaults.

Each wrapper clamps its blocks to the array (as the reference does),
checks that they tile it, and calls the registered custom op: CUDA
tensors reach the hand kernel (or raise), CPU tensors run the plain
version.  The counter (:mod:`repro_torch.core.counting`) meets the same
custom op and prices it with its cost rule instead of running it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import dg_diff as _dg
from repro_torch.kernels import matmul_tiled as _mm
from repro_torch.kernels import microbench as _mb
from repro_torch.kernels import stencil5 as _st


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
           block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims differ, {k} vs {k2}")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"matmul: ({m}, {n}, {k}) does not tile by "
                         f"({bm}, {bn}, {bk})")
    return _mm.matmul_tiled(a, b, bm, bn, bk)


def stencil5(u: torch.Tensor, *, block_m: int = 256,
             block_n: int = 256) -> torch.Tensor:
    m, n = u.shape
    bm, bn = min(block_m, m), min(block_n, n)
    if m % bm or n % bn:
        raise ValueError(f"stencil5: ({m}, {n}) does not tile by "
                         f"({bm}, {bn})")
    return _st.stencil5(u, bm, bn)


def dg_diff(diff_mat: torch.Tensor, ut: torch.Tensor, *,
            block_e: int = 512) -> torch.Tensor:
    k = ut.shape[1]
    be = min(block_e, k)
    if k % be:
        raise ValueError(f"dg_diff: K={k} does not tile by block_e={be}")
    return _dg.dg_diff(diff_mat, ut, be)


def stream_strided(arrays: Sequence[torch.Tensor], *, block: int = 512,
                   stride: int = 1) -> torch.Tensor:
    (s,) = arrays[0].shape
    n_out = s // (block * stride)
    if n_out * block * stride != s:
        raise ValueError(f"stream_strided: S={s} is not n_out·block·stride "
                         f"for block={block}, stride={stride}")
    return _mb.stream_strided(list(arrays), block, stride)


def madd_throughput(x: torch.Tensor, *, iters: int = 256, block: int = 2048,
                    a: float = 1.000001, b: float = 1e-7) -> torch.Tensor:
    (s,) = x.shape
    blk = min(block, s)
    if s % blk:
        raise ValueError(f"madd_throughput: S={s} does not tile by "
                         f"block={blk}")
    return _mb.madd_throughput(x, iters, blk, a, b)
