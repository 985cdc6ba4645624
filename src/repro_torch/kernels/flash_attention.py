"""Flash attention on Hopper — the counterpart of
``repro.kernels.flash_attention`` (TPU kernel ``_flash_kernel``).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` on CUDA
tensors; the custom op ``repro_torch::flash_attention`` runs the plain
version on CPU tensors and gives the counter its fake impl.  One CUDA
block owns a query tile of a (batch, head) and streams the keys in
``TILE_K``-row tiles with the softmax state in registers, visiting only
the kv tiles its rows can see (:func:`kv_tile_range`): bf16 on the
tensor cores (``mma.sync``) with 128-row query tiles, f32 as FMA with
64-row ones (``TILE_Q``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: launches of the CUDA kernel in this process
launches = 0

#: query rows a CUDA block owns, by operand dtype, and key rows per
#: inner step (kTileQ of each path, and kTileK, in the source)
TILE_Q = {torch.bfloat16: 128, torch.float32: 64}
TILE_K = 64
#: largest head dimension (D and Dv) the kernel takes
MAX_HEAD_DIM = 256

_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}


def kv_tile_range(q_first: int, q_last: int, skv: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """The kv tiles ``[lo, hi)`` query rows ``[q_first, q_last]`` can see,
    as the kernel computes them: keys ``[max(0, q_first − window + 1),
    min(Skv, q_last + 1))`` — the lower end only with a window, the upper
    end only when causal (none under a causal mask with window 0) —
    rounded out to whole ``TILE_K`` tiles."""
    lo = max(0, q_first - window + 1) if window is not None else 0
    hi = skv if not causal else 0 if window == 0 else min(skv, q_last + 1)
    t_lo = lo // TILE_K
    return (t_lo, -(-hi // TILE_K)) if lo < hi else (t_lo, t_lo)


def kv_tiles_visited(sq: int, skv: int, causal: bool, window: Optional[int],
                     tile_q: int) -> int:
    """kv tiles the kernel stages for one (batch, head), summed over its
    ``tile_q``-row query tiles (a full sweep stages ``ceil(Sq / tile_q) ·
    ceil(Skv / TILE_K)``)."""
    total = 0
    for q0 in range(0, sq, tile_q):
        lo, hi = kv_tile_range(q0, min(q0 + tile_q, sq) - 1, skv, causal,
                               window)
        total += hi - lo
    return total


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float, block_q: int,
                    block_k: int) -> torch.Tensor:
    """q[B, Sq, Hq, D], k/v[B, Skv, Hkv, D*] → [B, Sq, Hq, Dv]."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int],
                         softcap: Optional[float], scale: float,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Check the operands, launch ``csrc/flash_attention.cu``, count the
    launch."""
    global launches
    b, sq, hq, d = q.shape
    b2, skv, hkv, d2 = k.shape
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dv = v.shape[3]
    if b2 != b or d2 != d or v.shape[:3] != k.shape[:3] or hq % hkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous operands")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands must share one device")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    _build.launch_on(q.device, _ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, d,
                     dv, scale, 0.0 if softcap is None else softcap,
                     int(causal), -1 if window is None else window)
    launches += 1
    return out


@flash_attention.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale, block_q,
                          block_k):
    return q.new_empty((*q.shape[:3], v.shape[3]))
