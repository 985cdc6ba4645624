"""Five-point stencil on Hopper — the counterpart of
``repro.kernels.stencil5`` (TPU kernel ``_stencil_kernel``).

``stencil5_cuda`` launches ``csrc/stencil5.cu`` on CUDA tensors (zero
padding handled in the kernel: no padded copy is written); the custom op
``repro_torch::stencil5`` runs the plain version on CPU tensors and
gives the counter its fake impl.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil5_ref

#: launches of the CUDA kernel in this process
launches = 0

#: rows per shared-memory strip in csrc/stencil5.cu (kStripRows)
STRIP_ROWS = 32
_SMEM_LIMIT = 232448    # bytes of shared memory one block may use (H100)


@torch.library.custom_op("repro_torch::stencil5", mutates_args=(),
                         device_types="cpu")
def stencil5(u: torch.Tensor, block_m: int, block_n: int) -> torch.Tensor:
    """u[M, N] → 5-point Laplacian of the zero-padded u, [M, N]."""
    return stencil5_ref(u)


def stencil5_cuda(u: torch.Tensor, block_m: int,
                  block_n: int) -> torch.Tensor:
    """Check the input, launch ``csrc/stencil5.cu``, count the launch."""
    global launches
    m, n = u.shape
    if u.dtype != torch.float32:
        raise TypeError(f"stencil5 takes float32, got {u.dtype}")
    if m % block_m or n % block_n:
        raise ValueError(f"stencil5: {tuple(u.shape)} does not tile by "
                         f"({block_m}, {block_n})")
    if (STRIP_ROWS + 2) * (block_n + 2) * 4 > _SMEM_LIMIT:
        raise ValueError(f"stencil5: block_n={block_n} needs more shared "
                         f"memory than one block has")
    if not u.is_contiguous():
        raise ValueError("stencil5 takes a contiguous input")
    out = torch.empty_like(u)
    _build.launch_on(u.device, "repro_stencil5_f32", u.data_ptr(),
                     out.data_ptr(), m, n, block_m, block_n)
    launches += 1
    return out


@stencil5.register_fake
def _stencil5_fake(u, block_m, block_n):
    return torch.empty_like(u)
