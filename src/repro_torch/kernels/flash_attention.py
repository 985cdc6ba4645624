"""Flash attention on Hopper — the counterpart of
``repro.kernels.flash_attention`` (TPU kernel ``_flash_kernel``).

``repro_torch::flash_attention`` launches ``csrc/flash_attention.cu``
(one CUDA block per 64-row query tile of a (batch, head), streaming the
keys in 64-row tiles with the softmax state in registers) for CUDA
tensors, f32 or bf16, and runs the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: launches of the CUDA kernel in this process
launches = 0

#: query rows a CUDA block owns, and key rows per inner step
TILE_Q = TILE_K = 64
#: largest head dimension (D and Dv) the kernel takes
MAX_HEAD_DIM = 256

_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float, block_q: int,
                    block_k: int) -> torch.Tensor:
    """q[B, Sq, Hq, D], k/v[B, Skv, Hkv, D*] → [B, Sq, Hq, Dv]."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


@flash_attention.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, window, softcap, scale, block_q,
                          block_k):
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
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous operands")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands must share one device")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, d,
                      dv, scale, 0.0 if softcap is None else softcap,
                      int(causal), -1 if window is None else window,
                      torch.cuda.current_stream().cuda_stream)
    launches += 1
    return out


@flash_attention.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale, block_q,
                          block_k):
    return q.new_empty((*q.shape[:3], v.shape[3]))
