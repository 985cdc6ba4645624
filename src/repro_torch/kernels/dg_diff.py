"""DG element-wise differentiation on Hopper — the counterpart of
``repro.kernels.dg_diff`` (TPU kernel ``_dg_kernel``).

``repro_torch::dg_diff`` launches ``csrc/dg_diff.cu`` for CUDA tensors
(D_m resident in shared memory across the element sweep) and runs the
plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dg_diff_ref

#: launches of the CUDA kernel in this process
launches = 0

#: unit-node counts the CUDA kernel is instantiated for
SUPPORTED_N = (8, 16, 32, 64)


@torch.library.custom_op("repro_torch::dg_diff", mutates_args=(),
                         device_types="cpu")
def dg_diff(diff_mat: torch.Tensor, ut: torch.Tensor,
            block_e: int) -> torch.Tensor:
    """diff_mat[M, N, N], ut[N, K] → [M, N, K]."""
    return dg_diff_ref(diff_mat, ut)


@dg_diff.register_kernel("cuda")
def _dg_diff_cuda(diff_mat, ut, block_e):
    global launches
    m, n, n2 = diff_mat.shape
    n3, k = ut.shape
    if diff_mat.dtype != torch.float32 or ut.dtype != torch.float32:
        raise TypeError(f"dg_diff takes float32, got {diff_mat.dtype} and "
                        f"{ut.dtype}")
    if not (n == n2 == n3) or k % block_e:
        raise ValueError(f"dg_diff: shapes {tuple(diff_mat.shape)}, "
                         f"{tuple(ut.shape)} with block_e={block_e}")
    if n not in SUPPORTED_N:
        raise ValueError(f"dg_diff kernel supports N in {SUPPORTED_N}, "
                         f"got {n}")
    if not (diff_mat.is_contiguous() and ut.is_contiguous()):
        raise ValueError("dg_diff takes contiguous operands")
    if ut.device != diff_mat.device:
        raise ValueError("dg_diff operands must share one device")
    out = torch.empty((m, n, k), dtype=ut.dtype, device=ut.device)
    with torch.cuda.device(ut.device):
        _build.launch("repro_dg_diff_f32", diff_mat.data_ptr(),
                      ut.data_ptr(), out.data_ptr(), m, n, k, block_e,
                      torch.cuda.current_stream().cuda_stream)
    launches += 1
    return out


@dg_diff.register_fake
def _dg_diff_fake(diff_mat, ut, block_e):
    return ut.new_empty((diff_mat.shape[0], diff_mat.shape[1], ut.shape[1]))
