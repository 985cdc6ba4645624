"""Plain PyTorch versions of the ported kernels: the CPU path of each
wrapper and the oracle each CUDA kernel is held against on the card.
Counterparts of ``repro.kernels.ref``.

Like the reference they compute in float32 at least (bf16 inputs are
widened); float64 inputs stay float64, so the card's check can evaluate
the plain version on float64 copies of a kernel's inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_wide(a) @ _wide(b)).to(a.dtype)


def stencil5_ref(u: torch.Tensor) -> torch.Tensor:
    up = F.pad(_wide(u), (1, 1, 1, 1))
    out = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
           - 4.0 * up[1:-1, 1:-1])
    return out.to(u.dtype)


def dg_diff_ref(diff_mat: torch.Tensor, ut: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mij,jk->mik", _wide(diff_mat),
                        _wide(ut)).to(ut.dtype)
