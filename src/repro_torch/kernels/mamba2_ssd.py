"""Mamba-2 SSD chunked scan on Hopper — the counterpart of
``repro.kernels.mamba2_ssd`` (TPU kernel ``_ssd_kernel``).

``mamba2_ssd_cuda`` launches ``csrc/mamba2_ssd.cu`` (one CUDA block per
(batch, head) walking the chunks in order, the [P, N] state in shared
memory) on CUDA tensors; the custom op ``repro_torch::mamba2_ssd`` runs
the plain sequential recurrence on CPU tensors and gives the counter its
fake impl.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref

#: launches of the CUDA kernel in this process
launches = 0

#: sub-tile of the chunk's L × L form (rows and columns)
TILE = 64
#: largest chunk, head dim P and state dim N the kernel takes
MAX_CHUNK = 256
MAX_DIM = 64


@torch.library.custom_op("repro_torch::mamba2_ssd", mutates_args=(),
                         device_types="cpu")
def mamba2_ssd(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """xdt[B, S, H, P], da[B, S, H], bm/cm[B, S, H, N] → [B, S, H, P]."""
    return ssd_ref(xdt, da, bm, cm)


def mamba2_ssd_cuda(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                    cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Check the operands, launch ``csrc/mamba2_ssd.cu``, count the
    launch."""
    global launches
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    if any(t.dtype != torch.float32 for t in (xdt, da, bm, cm)):
        raise TypeError(f"mamba2_ssd takes float32, got {xdt.dtype}, "
                        f"{da.dtype}, {bm.dtype}, {cm.dtype}")
    if da.shape != (b, s, h) or bm.shape != (b, s, h, n) \
            or cm.shape != bm.shape or s % chunk:
        raise ValueError(f"mamba2_ssd: shapes {tuple(xdt.shape)}, "
                         f"{tuple(da.shape)}, {tuple(bm.shape)}, "
                         f"{tuple(cm.shape)} with chunk={chunk}")
    if p > MAX_DIM or n > MAX_DIM or chunk > MAX_CHUNK:
        raise ValueError(f"mamba2_ssd kernel takes P, N <= {MAX_DIM} and "
                         f"chunk <= {MAX_CHUNK}, got P={p}, N={n}, "
                         f"chunk={chunk}")
    if not all(t.is_contiguous() for t in (xdt, da, bm, cm)):
        raise ValueError("mamba2_ssd takes contiguous operands")
    if any(t.device != xdt.device for t in (da, bm, cm)):
        raise ValueError("mamba2_ssd operands must share one device")
    out = torch.empty_like(xdt)
    _build.launch_on(xdt.device, "repro_mamba2_ssd_f32", xdt.data_ptr(),
                     da.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                     out.data_ptr(), b, s, h, p, n, chunk)
    launches += 1
    return out


@mamba2_ssd.register_fake
def _mamba2_ssd_fake(xdt, da, bm, cm, chunk):
    return torch.empty_like(xdt)
