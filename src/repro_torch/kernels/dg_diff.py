"""DG element-wise differentiation on Hopper — the counterpart of
``repro.kernels.dg_diff`` (TPU kernel ``_dg_kernel``).

``dg_diff_cuda`` launches ``csrc/dg_diff.cu`` on CUDA tensors; the
custom op ``repro_torch::dg_diff`` runs the plain version on CPU tensors
and gives the counter its fake impl.  The kernel takes any N ≤ 64: it is
instantiated at the widths :data:`WIDTHS` and runs an N between them at
the next width, masking rows and columns ≥ N.  The CUDA grid is the
kernel's own: one block per slab of ``slab_width(N)`` elements stages
its ``SLAB_FLOATS`` floats of ut in shared memory once and computes all
M outputs of the slab, walking m with D_m staged beside it, whatever
``block_e`` is; ``block_e`` is the reference's grid, which the wrapper
still checks and the cost rule (:mod:`repro_torch.analysis.kernelcost`)
reports.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dg_diff_ref

#: launches of the CUDA kernel in this process
launches = 0

#: unit-node counts the CUDA kernel is instantiated for; any N up to the
#: last runs at the first width at or above it
WIDTHS = (8, 16, 32, 64)

#: floats of ut one CUDA block stages (N rows × its slab width;
#: kSlabFloats in the source)
SLAB_FLOATS = 8192


def width(n: int) -> int:
    """The instantiated width the kernel runs N = ``n`` at (W in the
    source)."""
    for w in WIDTHS:
        if n <= w:
            return w
    raise ValueError(f"dg_diff kernel takes N <= {WIDTHS[-1]}, got {n}")


def slab_width(n: int) -> int:
    """Elements of one CUDA block's slab at N = ``n`` (E in the source)."""
    return SLAB_FLOATS // width(n)


@torch.library.custom_op("repro_torch::dg_diff", mutates_args=(),
                         device_types="cpu")
def dg_diff(diff_mat: torch.Tensor, ut: torch.Tensor,
            block_e: int) -> torch.Tensor:
    """diff_mat[M, N, N], ut[N, K] → [M, N, K]."""
    return dg_diff_ref(diff_mat, ut)


def dg_diff_cuda(diff_mat: torch.Tensor, ut: torch.Tensor,
                 block_e: int) -> torch.Tensor:
    """Check the operands, launch ``csrc/dg_diff.cu``, count the
    launch."""
    global launches
    m, n, n2 = diff_mat.shape
    n3, k = ut.shape
    if diff_mat.dtype != torch.float32 or ut.dtype != torch.float32:
        raise TypeError(f"dg_diff takes float32, got {diff_mat.dtype} and "
                        f"{ut.dtype}")
    if not (n == n2 == n3) or k % block_e:
        raise ValueError(f"dg_diff: shapes {tuple(diff_mat.shape)}, "
                         f"{tuple(ut.shape)} with block_e={block_e}")
    if not 1 <= n <= WIDTHS[-1]:
        raise ValueError(f"dg_diff kernel takes 1 <= N <= {WIDTHS[-1]}, "
                         f"got {n}")
    if not (diff_mat.is_contiguous() and ut.is_contiguous()):
        raise ValueError("dg_diff takes contiguous operands")
    if ut.device != diff_mat.device:
        raise ValueError("dg_diff operands must share one device")
    out = ut.new_empty((m, n, k))
    _build.launch_on(ut.device, "repro_dg_diff_f32", diff_mat.data_ptr(),
                     ut.data_ptr(), out.data_ptr(), m, n, k)
    launches += 1
    return out


@dg_diff.register_fake
def _dg_diff_fake(diff_mat, ut, block_e):
    return ut.new_empty((diff_mat.shape[0], diff_mat.shape[1], ut.shape[1]))
