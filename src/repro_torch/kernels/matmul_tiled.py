"""Tiled matrix product on Hopper — the counterpart of
``repro.kernels.matmul_tiled`` (TPU kernel ``_matmul_kernel``).

``matmul_tiled_cuda`` launches ``csrc/matmul_tiled.cu`` on CUDA tensors;
the custom op ``repro_torch::matmul_tiled`` runs the plain version on
CPU tensors and gives the counter its fake impl.  The CUDA grid is
the kernel's own — one block per ``TILE`` output tile, staging k
``STAGE_K`` deep through a 3-stage ``cp.async`` ring and summing each
16-deep slice into its own partial — whatever the block sizes are; those
are the reference's grid, which the wrapper still checks and the cost
rule (:mod:`repro_torch.analysis.kernelcost`) reports.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; callers reset it to 0 to count one run)
launches = 0

#: output tile of one CUDA block (kTileM, kTileN in the source) and the
#: k depth of one stage of its ring (kStageK)
TILE = (128, 128)
STAGE_K = 32

_ENTRY = {torch.float32: "repro_matmul_tiled_f32",
          torch.bfloat16: "repro_matmul_tiled_bf16"}


@torch.library.custom_op("repro_torch::matmul_tiled", mutates_args=(),
                         device_types="cpu")
def matmul_tiled(a: torch.Tensor, b: torch.Tensor, block_m: int,
                 block_n: int, block_k: int) -> torch.Tensor:
    """a[M, K] @ b[K, N] → [M, N]; on the CPU the plain version (the
    tiling does not change the result)."""
    return matmul_ref(a, b)


def matmul_tiled_cuda(a: torch.Tensor, b: torch.Tensor, block_m: int,
                      block_n: int, block_k: int) -> torch.Tensor:
    """Check the operands, launch ``csrc/matmul_tiled.cu``, count the
    launch."""
    global launches
    (m, k), (k2, n) = a.shape, b.shape
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"matmul_tiled takes float32 or bfloat16 operands "
                        f"of one dtype, got {a.dtype} and {b.dtype}")
    if k != k2 or m % block_m or n % block_n or k % block_k:
        raise ValueError(f"matmul_tiled: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not tile by "
                         f"({block_m}, {block_n}, {block_k})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_tiled takes contiguous operands")
    if b.device != a.device:
        raise ValueError("matmul_tiled operands must share one device")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _build.launch_on(a.device, _ENTRY[a.dtype], a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), m, n, k)
    launches += 1
    return out


@matmul_tiled.register_fake
def _matmul_tiled_fake(a, b, block_m, block_n, block_k):
    return a.new_empty((a.shape[0], b.shape[1]))
