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

Gradients: under autograd the forward keeps its trajectory, per step
the gate pre-activations and c, n, m ([B, S, 7, H, dh] f32): on the
card :class:`SLSTMCell` launches the forward kernel with its trajectory
pointer set (``slstm_cell_traj_cuda``) and its backward launches
``csrc/slstm_cell_bwd.cu`` (``slstm_cell_bwd_cuda``: the reverse
recurrence, one cluster per (batch row, head) as the forward, summing
dR and db on the way into per-cluster partials that one ``sum`` adds;
``slstm_cell_dgg_cuda`` launches it for dg_in alone).  On the
host ``repro_torch::slstm_cell_traj`` (CPU impl
``ref.slstm_cell_fwd_traj_ref``) is the op autograd differentiates, and
its backward calls ``repro_torch::slstm_cell_bwd`` (CPU impl
``ref.slstm_cell_bwd_ref``); their fake impls let the counter price a
training step.  The reference has no backward kernel: it differentiates
its jnp cell.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, _observe
from repro_torch.kernels.ref import (slstm_cell_bwd_ref,
                                    slstm_cell_fwd_traj_ref, slstm_cell_ref,
                                    slstm_cell_state_ref)

_log = logging.getLogger(__name__)

#: launches of the CUDA kernel in this process (with or without the
#: trajectory)
launches = 0
#: launches of the backward CUDA kernel in this process
backward_launches = 0

#: largest head width dh the kernel takes
MAX_DH = 256
#: rows of the trajectory a step: the gate pre-activations i, f, z, o
#: and c, n, m after the step
TRAJ_ROWS = 7
#: (device, B, H, dh) → the launch plan met (``launch_plan``), of the
#: forward and of the backward
plans: Dict[Tuple[torch.device, int, int, int], Dict[str, int]] = {}
bwd_plans: Dict[Tuple[torch.device, int, int, int], Dict[str, int]] = {}


def cluster_blocks(dh: int) -> int:
    """Blocks of the cluster that runs one (batch row, head): each holds
    ``ceil(dh / cluster_blocks(dh))`` hidden units and their r in
    registers.  The kernel is built for these two sizes and takes the
    size from its caller."""
    return 8 if dh > 192 else 6


def launch_plan(batch: int, heads: int, dh: int, device,
                entry: str = "repro_slstm_cell_plan") -> Dict[str, int]:
    """A kernel's launch plan on ``device`` (the forward's, or with
    ``entry="repro_slstm_cell_bwd_plan"`` the backward's): blocks per
    cluster, batch rows per cluster (1 when all B·H clusters can be
    resident at once, else 2), the clusters that can be resident at once
    (``cudaOccupancyMaxActiveClusters``) and threads per block."""
    out = (ctypes.c_int * 3)()
    _build.launch_on(device, entry, batch, heads, dh, cluster_blocks(dh),
                     out, stream=False)
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
    return _launch(g_in, r_gates, b_gates, None, None)


def slstm_cell_state_cuda(g_in: torch.Tensor, r_gates: torch.Tensor,
                          b_gates: torch.Tensor):
    """:func:`slstm_cell_cuda` with the state after the last step: (h
    [B, S, H, dh], c, n, m stacked [3, B, H, dh] f32)."""
    b, _, _, h, dh = g_in.shape
    state = torch.zeros((3, b, h, dh), dtype=torch.float32,
                        device=g_in.device)
    return _launch(g_in, r_gates, b_gates, state, None), state


def slstm_cell_traj_cuda(g_in: torch.Tensor, r_gates: torch.Tensor,
                         b_gates: torch.Tensor):
    """:func:`slstm_cell_cuda` keeping what the backward reads: (h, the
    trajectory [B, S, 7, H, dh] f32 of each step's gate pre-activations
    i, f, z, o and c, n, m after it)."""
    b, s, _, h, dh = g_in.shape
    traj = torch.empty((b, s, TRAJ_ROWS, h, dh), dtype=torch.float32,
                       device=g_in.device)
    return _launch(g_in, r_gates, b_gates, None, traj), traj


def _plan(found: Dict, entry: str, device, b: int, h: int,
          dh: int) -> Dict[str, int]:
    """The launch plan of C entry ``entry`` for (B, H, dh) on ``device``,
    queried and logged once into ``found``."""
    key = (device, b, h, dh)
    if key not in found:
        found[key] = launch_plan(b, h, dh, device, entry)
        _log.info("%s on %s for B=%d H=%d dh=%d: %s", entry, device, b, h,
                  dh, found[key])
    return found[key]


def _check(g_in: torch.Tensor, r_gates: torch.Tensor,
           b_gates: torch.Tensor) -> None:
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


def _launch(g_in: torch.Tensor, r_gates: torch.Tensor,
            b_gates: torch.Tensor, state: Optional[torch.Tensor],
            traj: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    _check(g_in, r_gates, b_gates)
    b, s, _, h, dh = g_in.shape
    out = torch.empty((b, s, h, dh), dtype=g_in.dtype, device=g_in.device)
    if not (b and s and h):
        return out
    plan = _plan(plans, "repro_slstm_cell_plan", g_in.device, b, h, dh)
    _build.launch_on(g_in.device, "repro_slstm_cell_f32", g_in.data_ptr(),
                     r_gates.data_ptr(), b_gates.data_ptr(), out.data_ptr(),
                     0 if state is None else state.data_ptr(),
                     0 if traj is None else traj.data_ptr(), b, s, h, dh,
                     plan["cluster_blocks"], plan["rows_per_cluster"])
    launches += 1
    _observe.launched("slstm_cell" if state is None and traj is None else
                      "slstm_cell_state" if traj is None else
                      "slstm_cell_traj", (g_in, r_gates, b_gates),
                      (out, state, traj))
    return out


def _bwd_check(traj: torch.Tensor, r_gates: torch.Tensor, dy: torch.Tensor,
               *more: torch.Tensor) -> None:
    """Raise on backward operands the kernel does not take (``more``: the
    forward's h, shaped as dy)."""
    b, s, rows, hh, dh = traj.shape
    ops = (traj, r_gates, dy, *more)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"slstm_cell backward takes float32, got "
                        f"{[t.dtype for t in ops]}")
    if rows != TRAJ_ROWS or r_gates.shape != (hh, dh, 4, dh) \
            or any(t.shape != (b, s, hh, dh) for t in (dy, *more)):
        raise ValueError(f"slstm_cell backward: shapes "
                         f"{[tuple(t.shape) for t in ops]}")
    if dh > MAX_DH:
        raise ValueError(f"slstm_cell kernel takes dh <= {MAX_DH}, got {dh}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("slstm_cell backward takes contiguous operands")
    if any(t.device != traj.device for t in ops):
        raise ValueError("slstm_cell backward operands must share one device")


def _bwd_launch(traj: torch.Tensor, h: Optional[torch.Tensor],
                r_gates: torch.Tensor, dy: torch.Tensor):
    """Launch ``csrc/slstm_cell_bwd.cu`` and count the launch: dgg, and
    with ``h`` each cluster's partial sums of dR and db (else None)."""
    global backward_launches
    b, s, _, hh, dh = traj.shape
    dev = traj.device
    dgg = torch.empty((b, s, 4, hh, dh), dtype=torch.float32, device=dev)
    if not (b and s and hh):
        zero = torch.zeros((0, hh, dh, 4, dh), dtype=torch.float32,
                           device=dev)
        return dgg, zero, zero.new_zeros((0, 4, hh, dh))
    plan = _plan(bwd_plans, "repro_slstm_cell_bwd_plan", dev, b, hh, dh)
    parts = (None, None)
    if h is not None:
        clusters = -(-b // plan["rows_per_cluster"])
        parts = (torch.empty((clusters, hh, dh, 4, dh), dtype=torch.float32,
                             device=dev),
                 torch.empty((clusters, 4, hh, dh), dtype=torch.float32,
                             device=dev))
    _build.launch_on(dev, "repro_slstm_cell_bwd_f32", traj.data_ptr(),
                     0 if h is None else h.data_ptr(), r_gates.data_ptr(),
                     dy.data_ptr(), dgg.data_ptr(),
                     *(0 if t is None else t.data_ptr() for t in parts),
                     b, s, hh, dh, plan["cluster_blocks"],
                     plan["rows_per_cluster"])
    backward_launches += 1
    _observe.launched("slstm_cell_bwd", (traj, h, r_gates, dy),
                      (dgg, *parts))
    return (dgg, *parts)


def slstm_cell_dgg_cuda(traj: torch.Tensor, r_gates: torch.Tensor,
                        dy: torch.Tensor) -> torch.Tensor:
    """Check the operands, launch ``csrc/slstm_cell_bwd.cu`` for dg_in
    alone (the reverse recurrence: the gate gradients dgg [B, S, 4, H,
    dh] from the forward's trajectory ``traj`` and the output gradient
    ``dy``; no dR, no db), count the launch."""
    _bwd_check(traj, r_gates, dy)
    return _bwd_launch(traj, None, r_gates, dy)[0]


def slstm_cell_bwd_cuda(traj: torch.Tensor, h: torch.Tensor,
                        r_gates: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dg_in, dr, db) from one launch of ``csrc/slstm_cell_bwd.cu`` (the
    reverse recurrence, summing dR and db as it walks; the forward's h
    gives dR's h_{t−1}): dR and db are its clusters' partial sums
    (``ref.slstm_param_partials_ref``) added over the clusters."""
    _bwd_check(traj, r_gates, dy, h)
    dgg, dr_part, db_part = _bwd_launch(traj, h, r_gates, dy)
    return dgg, dr_part.sum(0), db_part.sum(0)


@slstm_cell.register_fake
def _slstm_cell_fake(g_in, r_gates, b_gates):
    b, s, _, h, dh = g_in.shape
    return g_in.new_empty((b, s, h, dh))


@slstm_cell_state.register_fake
def _slstm_cell_state_fake(g_in, r_gates, b_gates):
    b, s, _, h, dh = g_in.shape
    return g_in.new_empty((b, s, h, dh)), g_in.new_empty(
        (3, b, h, dh), dtype=torch.promote_types(g_in.dtype, torch.float32))


@torch.library.custom_op("repro_torch::slstm_cell_traj", mutates_args=(),
                         device_types="cpu")
def slstm_cell_traj(g_in: torch.Tensor, r_gates: torch.Tensor,
                    b_gates: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`slstm_cell` and its trajectory [B, S, 7, H, dh] (float32 at
    least): the op autograd differentiates on the host."""
    return slstm_cell_fwd_traj_ref(g_in, r_gates, b_gates)


@slstm_cell_traj.register_fake
def _slstm_cell_traj_fake(g_in, r_gates, b_gates):
    b, s, _, h, dh = g_in.shape
    return g_in.new_empty((b, s, h, dh)), g_in.new_empty(
        (b, s, TRAJ_ROWS, h, dh),
        dtype=torch.promote_types(g_in.dtype, torch.float32))


@torch.library.custom_op("repro_torch::slstm_cell_bwd", mutates_args=(),
                         device_types="cpu")
def slstm_cell_bwd(traj: torch.Tensor, h: torch.Tensor,
                   r_gates: torch.Tensor, dy: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``repro_torch::slstm_cell_traj``'s h: (dg_in, dr,
    db) for the output gradient ``dy``, by the backward kernel's
    algorithm in PyTorch."""
    return slstm_cell_bwd_ref(traj, h, r_gates, dy)


@slstm_cell_bwd.register_fake
def _slstm_cell_bwd_fake(traj, h, r_gates, dy):
    b, s, _, hh, dh = traj.shape
    return (dy.new_empty((b, s, 4, hh, dh)), torch.empty_like(r_gates),
            r_gates.new_empty((4, hh, dh)))


class SLSTMCell(torch.autograd.Function):
    """The card's sLSTM under autograd: the forward kernel keeping its
    trajectory, and the backward kernel as its backward."""

    @staticmethod
    def forward(ctx, g_in, r_gates, b_gates):
        h, traj = slstm_cell_traj_cuda(g_in, r_gates, b_gates)
        ctx.save_for_backward(traj, h, r_gates)
        return h

    @staticmethod
    def backward(ctx, dh):
        return slstm_cell_bwd_cuda(*ctx.saved_tensors, dh.contiguous())


def _setup_context(ctx, inputs, output):
    h, traj = output
    ctx.set_materialize_grads(False)   # no zeros made for traj's gradient
    ctx.save_for_backward(traj, h, inputs[1])


def _backward(ctx, dh, dtraj):
    return slstm_cell_bwd(*ctx.saved_tensors, dh.contiguous())


slstm_cell_traj.register_autograd(_backward, setup_context=_setup_context)
