"""sLSTM recurrent cell on Hopper — the counterpart of
``repro.kernels.slstm_cell`` (TPU kernel ``_slstm_kernel``).

``slstm_cell_cuda`` launches ``csrc/slstm_cell.cu`` (one thread-block
cluster per (batch row, head) running the whole time loop, each block
holding its share of the hidden units with their slice of r in
registers, h exchanged through distributed shared memory) on CUDA
tensors; the custom op ``repro_torch::slstm_cell`` runs the plain
sequential cell on CPU tensors and gives the counter its fake impl.
``slstm_cell_state_cuda`` launches the same kernel with its gating
threads also storing c, n, m after the last step, which a served
prefill leaves in the cache; its custom op
``repro_torch::slstm_cell_state`` runs ``ref.slstm_cell_state_ref``.

Gradients: the custom op's autograd is the plain version's vjp
(``ref.plain_vjp``), so the host trains through it; on the card
:class:`SLSTMCell` runs the forward kernel and its backward raises, as
no backward kernel exists yet (ROADMAP queue B).
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (plain_vjp, slstm_cell_ref,
                                    slstm_cell_state_ref)

_log = logging.getLogger(__name__)

#: launches of the CUDA kernel in this process
launches = 0

#: largest head width dh the kernel takes
MAX_DH = 256
#: (device, B, H, dh) → the launch plan met (``launch_plan``)
plans: Dict[Tuple[torch.device, int, int, int], Dict[str, int]] = {}


def cluster_blocks(dh: int) -> int:
    """Blocks of the cluster that runs one (batch row, head): each holds
    ``ceil(dh / cluster_blocks(dh))`` hidden units and their r in
    registers.  The kernel is built for these two sizes and takes the
    size from its caller."""
    return 8 if dh > 192 else 6


def launch_plan(batch: int, heads: int, dh: int, device) -> Dict[str, int]:
    """The kernel's launch plan on ``device``: blocks per cluster, batch
    rows per cluster (1 when all B·H clusters can be resident at once,
    else 2), the clusters that can be resident at once
    (``cudaOccupancyMaxActiveClusters``) and threads per block."""
    out = (ctypes.c_int * 3)()
    _build.launch_on(device, "repro_slstm_cell_plan", batch, heads, dh,
                     cluster_blocks(dh), out, stream=False)
    return dict(cluster_blocks=cluster_blocks(dh),
                **dict(zip(("rows_per_cluster", "max_active_clusters",
                            "threads"), out)))


@torch.library.custom_op("repro_torch::slstm_cell", mutates_args=(),
                         device_types="cpu")
def slstm_cell(g_in: torch.Tensor, r_gates: torch.Tensor,
               b_gates: torch.Tensor) -> torch.Tensor:
    """g_in[B, S, 4, H, dh], r_gates[H, dh, 4, dh], b_gates[4, H, dh] →
    the hidden trajectory [B, S, H, dh]."""
    return slstm_cell_ref(g_in, r_gates, b_gates)


@torch.library.custom_op("repro_torch::slstm_cell_state", mutates_args=(),
                         device_types="cpu")
def slstm_cell_state(g_in: torch.Tensor, r_gates: torch.Tensor,
                     b_gates: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`slstm_cell` and the state after the last step: c, n, m
    stacked [3, B, H, dh] (float32 at least)."""
    h, cnm = slstm_cell_state_ref(g_in, r_gates, b_gates)
    return h, torch.stack(cnm)


def slstm_cell_cuda(g_in: torch.Tensor, r_gates: torch.Tensor,
                    b_gates: torch.Tensor) -> torch.Tensor:
    """Check the operands, launch ``csrc/slstm_cell.cu``, count the
    launch.  The launch plan of each new (B, H, dh) is queried and logged
    once."""
    return _launch(g_in, r_gates, b_gates, None)


def slstm_cell_state_cuda(g_in: torch.Tensor, r_gates: torch.Tensor,
                          b_gates: torch.Tensor):
    """:func:`slstm_cell_cuda` with the state after the last step: (h
    [B, S, H, dh], c, n, m stacked [3, B, H, dh] f32)."""
    b, _, _, h, dh = g_in.shape
    state = torch.zeros((3, b, h, dh), dtype=torch.float32,
                        device=g_in.device)
    return _launch(g_in, r_gates, b_gates, state), state


def _launch(g_in: torch.Tensor, r_gates: torch.Tensor,
            b_gates: torch.Tensor, state: Optional[torch.Tensor]
            ) -> torch.Tensor:
    global launches
    b, s, four, h, dh = g_in.shape
    if any(t.dtype != torch.float32 for t in (g_in, r_gates, b_gates)):
        raise TypeError(f"slstm_cell takes float32, got {g_in.dtype}, "
                        f"{r_gates.dtype}, {b_gates.dtype}")
    if four != 4 or r_gates.shape != (h, dh, 4, dh) \
            or b_gates.shape != (4, h, dh):
        raise ValueError(f"slstm_cell: shapes {tuple(g_in.shape)}, "
                         f"{tuple(r_gates.shape)}, {tuple(b_gates.shape)}")
    if dh > MAX_DH:
        raise ValueError(f"slstm_cell kernel takes dh <= {MAX_DH}, got {dh}")
    if not all(t.is_contiguous() for t in (g_in, r_gates, b_gates)):
        raise ValueError("slstm_cell takes contiguous operands")
    if r_gates.device != g_in.device or b_gates.device != g_in.device:
        raise ValueError("slstm_cell operands must share one device")
    out = torch.empty((b, s, h, dh), dtype=g_in.dtype, device=g_in.device)
    if not (b and s and h):
        return out
    key = (g_in.device, b, h, dh)
    if key not in plans:
        plans[key] = launch_plan(b, h, dh, g_in.device)
        _log.info("slstm_cell plan on %s for B=%d H=%d dh=%d: %s",
                  g_in.device, b, h, dh, plans[key])
    _build.launch_on(g_in.device, "repro_slstm_cell_f32", g_in.data_ptr(),
                     r_gates.data_ptr(), b_gates.data_ptr(), out.data_ptr(),
                     0 if state is None else state.data_ptr(), b, s, h, dh,
                     plans[key]["cluster_blocks"],
                     plans[key]["rows_per_cluster"])
    launches += 1
    return out


@slstm_cell.register_fake
def _slstm_cell_fake(g_in, r_gates, b_gates):
    b, s, _, h, dh = g_in.shape
    return g_in.new_empty((b, s, h, dh))


@slstm_cell_state.register_fake
def _slstm_cell_state_fake(g_in, r_gates, b_gates):
    b, s, _, h, dh = g_in.shape
    return g_in.new_empty((b, s, h, dh)), g_in.new_empty(
        (3, b, h, dh), dtype=torch.promote_types(g_in.dtype, torch.float32))


class SLSTMCell(torch.autograd.Function):
    """The card's sLSTM under autograd: the forward kernel, and a
    backward that raises until a backward kernel exists."""

    @staticmethod
    def forward(ctx, g_in, r_gates, b_gates):
        return slstm_cell_cuda(g_in, r_gates, b_gates)

    @staticmethod
    def backward(ctx, dh):
        raise NotImplementedError(
            "slstm_cell backward kernel: ROADMAP queue B (the card trains "
            "no sLSTM block yet)")


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dh):
    return plain_vjp(slstm_cell_ref, ctx.saved_tensors, dh)


slstm_cell.register_autograd(_backward, setup_context=_setup_context)
