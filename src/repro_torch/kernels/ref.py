"""Plain PyTorch versions of the ported kernels: the CPU path of each
wrapper and the oracle each CUDA kernel is held against on the card.
Counterparts of ``repro.kernels.ref``.

Like the reference they compute in float32 at least (bf16 inputs are
widened); float64 inputs stay float64, so the card's check can evaluate
the plain version on float64 copies of a kernel's inputs.
"""
from __future__ import annotations

from typing import Sequence

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


def stream_ref(arrays: Sequence[torch.Tensor], *, block: int,
               stride: int) -> torch.Tensor:
    """Sum of the inputs' blocks ``i·stride`` into output block ``i``."""
    (s,) = arrays[0].shape
    n_out = s // (block * stride)
    acc = torch.zeros(n_out * block, dtype=_wide(arrays[0]).dtype,
                      device=arrays[0].device)
    for a in arrays:
        blocks = a.reshape(-1, block)[::stride][:n_out]
        acc = acc + _wide(blocks).reshape(-1)
    return acc.to(arrays[0].dtype)


def madd_ref(x: torch.Tensor, *, iters: int, a: float = 1.000001,
             b: float = 1e-7) -> torch.Tensor:
    """8 independent ``x·a + b`` chains, ``iters`` deep, summed in order.
    ``a`` and ``b`` are rounded to float32 first, as the kernel takes
    them, so a float64 evaluation differs from the kernel only by the
    kernel's own rounding."""
    w = _wide(x)
    a_t = torch.tensor(a, dtype=torch.float32).to(w.dtype)
    b_t = torch.tensor(b, dtype=torch.float32).to(w.dtype)
    xs = [w + i for i in range(8)]
    for _ in range(iters):
        xs = [xi * a_t + b_t for xi in xs]
    out = xs[0]
    for xi in xs[1:]:
        out = out + xi
    return out.to(x.dtype)
