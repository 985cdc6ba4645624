"""Public wrappers around the hand-written kernels — the counterpart of
``repro.kernels.ops``, with the reference's keyword names and block
defaults.

Each wrapper clamps its blocks to the array (as the reference does) and
checks that they tile it.  A tensor with data on the card goes straight
to the kernel's launcher (``*_cuda``: the hand kernel, or raise) — under
autograd, when an operand needs a gradient, through the kernel's
``autograd.Function`` (attention's backward is its backward kernel; the
SSD's and the sLSTM's raise); any other tensor meets the kernel's
custom op, which runs the plain version on the CPU (its autograd the
plain vjp) and has no CUDA kernel.  The counter
(:mod:`repro_torch.core.counting`) passes fake tensors, so it meets the
op and prices it with its cost rule instead of running it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import dg_diff as _dg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import matmul_tiled as _mm
from repro_torch.kernels import microbench as _mb
from repro_torch.kernels import slstm_cell as _sc
from repro_torch.kernels import stencil5 as _st


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` holds data on the card, so the wrapper launches the
    kernel itself: the dispatcher's round trip into a ``custom_op`` is
    host time that a card idle between short kernels waits for."""
    return t.is_cuda and not isinstance(t, FakeTensor)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
           block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims differ, {k} vs {k2}")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"matmul: ({m}, {n}, {k}) does not tile by "
                         f"({bm}, {bn}, {bk})")
    fn = _mm.matmul_tiled_cuda if _on_card(a) else _mm.matmul_tiled
    return fn(a, b, bm, bn, bk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D*] → [B, Sq, Hq, Dv]."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Skv={skv} do not tile "
                         f"by ({bq}, {bk})")
    if not _on_card(q):
        fn = _fa.flash_attention
    elif _needs_grad(q, k, v):
        fn = _fa.FlashAttention.apply
    else:
        fn = _fa.flash_attention_cuda
    return fn(q, k, v, causal, window, softcap, scale, bq, bk)


def mamba2_ssd(xdt: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """xdt: [B, S, H, P] (inputs pre-scaled by dt); da: [B, S, H] (dt·A);
    Bm, Cm: [B, S, H, N] (groups pre-broadcast) → y: [B, S, H, P]."""
    s = xdt.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba2_ssd: S={s} does not tile by chunk={chunk}")
    if not _on_card(xdt):
        fn = _ssd.mamba2_ssd
    elif _needs_grad(xdt, da, Bm, Cm):
        fn = _ssd.Mamba2SSD.apply
    else:
        fn = _ssd.mamba2_ssd_cuda
    return fn(xdt, da, Bm, Cm, chunk)


def mamba2_ssd_state(xdt: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, *, chunk: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba2_ssd` with the state after the last step: (y, state
    [B, H, P, N], float32).  The kernel writes it from its pass (b)."""
    s = xdt.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba2_ssd: S={s} does not tile by chunk={chunk}")
    fn = _ssd.mamba2_ssd_state_cuda if _on_card(xdt) \
        else _ssd.mamba2_ssd_state
    return fn(xdt, da, Bm, Cm, chunk)


def slstm_cell(g_in: torch.Tensor, r_gates: torch.Tensor,
               b_gates: torch.Tensor) -> torch.Tensor:
    """g_in: [B, S, 4, H, dh]; r_gates: [H, dh, 4, dh]; b_gates:
    [4, H, dh] → the hidden trajectory h: [B, S, H, dh]."""
    if g_in.dim() != 5 or g_in.shape[2] != 4:
        raise ValueError(f"slstm_cell: g_in must be [B, S, 4, H, dh], got "
                         f"{tuple(g_in.shape)}")
    if not _on_card(g_in):
        fn = _sc.slstm_cell
    elif _needs_grad(g_in, r_gates, b_gates):
        fn = _sc.SLSTMCell.apply
    else:
        fn = _sc.slstm_cell_cuda
    return fn(g_in, r_gates, b_gates)


def slstm_cell_state(g_in: torch.Tensor, r_gates: torch.Tensor,
                     b_gates: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """:func:`slstm_cell` with the state after the last step: (h,
    (c, n, m), each [B, H, dh] float32).  The kernel's gating threads
    store it after their last step."""
    if g_in.dim() != 5 or g_in.shape[2] != 4:
        raise ValueError(f"slstm_cell: g_in must be [B, S, 4, H, dh], got "
                         f"{tuple(g_in.shape)}")
    fn = _sc.slstm_cell_state_cuda if _on_card(g_in) \
        else _sc.slstm_cell_state
    h, state = fn(g_in, r_gates, b_gates)
    return h, tuple(state.unbind(0))


def stencil5(u: torch.Tensor, *, block_m: int = 256,
             block_n: int = 256) -> torch.Tensor:
    m, n = u.shape
    bm, bn = min(block_m, m), min(block_n, n)
    if m % bm or n % bn:
        raise ValueError(f"stencil5: ({m}, {n}) does not tile by "
                         f"({bm}, {bn})")
    fn = _st.stencil5_cuda if _on_card(u) else _st.stencil5
    return fn(u, bm, bn)


def dg_diff(diff_mat: torch.Tensor, ut: torch.Tensor, *,
            block_e: int = 512) -> torch.Tensor:
    k = ut.shape[1]
    be = min(block_e, k)
    if k % be:
        raise ValueError(f"dg_diff: K={k} does not tile by block_e={be}")
    fn = _dg.dg_diff_cuda if _on_card(ut) else _dg.dg_diff
    return fn(diff_mat, ut, be)


def stream_strided(arrays: Sequence[torch.Tensor], *, block: int = 512,
                   stride: int = 1) -> torch.Tensor:
    (s,) = arrays[0].shape
    n_out = s // (block * stride)
    if n_out * block * stride != s:
        raise ValueError(f"stream_strided: S={s} is not n_out·block·stride "
                         f"for block={block}, stride={stride}")
    fn = (_mb.stream_strided_cuda if _on_card(arrays[0])
          else _mb.stream_strided)
    return fn(list(arrays), block, stride)


def madd_throughput(x: torch.Tensor, *, iters: int = 256, block: int = 2048,
                    a: float = 1.000001, b: float = 1e-7) -> torch.Tensor:
    (s,) = x.shape
    blk = min(block, s)
    if s % blk:
        raise ValueError(f"madd_throughput: S={s} does not tile by "
                         f"block={blk}")
    fn = (_mb.madd_throughput_cuda if _on_card(x)
          else _mb.madd_throughput)
    return fn(x, iters, blk, a, b)
