"""Mamba-2 SSD chunked scan on Hopper — the counterpart of
``repro.kernels.mamba2_ssd`` (TPU kernel ``_ssd_kernel``).

``mamba2_ssd_cuda`` launches ``csrc/mamba2_ssd.cu`` on CUDA tensors in
three passes (each chunk's own state, the states passed along the
chunks, each chunk's output) over scratch it allocates; the custom op
``repro_torch::mamba2_ssd`` runs the plain sequential recurrence on CPU
tensors and gives the counter its fake impl.  ``mamba2_ssd_state_cuda``
launches the same passes with pass (b) also writing the state after the
last chunk, which a served prefill leaves in the cache; its custom op
``repro_torch::mamba2_ssd_state`` runs ``ref.ssd_state_ref``.

Gradients: the custom op's autograd is the plain version's vjp
(``ref.plain_vjp``), so the host trains through it; on the card
:class:`Mamba2SSD` runs the forward kernel and its backward raises, as
no backward kernel exists yet (ROADMAP queue B).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import plain_vjp, ssd_ref, ssd_state_ref

#: calls of ``mamba2_ssd_cuda`` that launched the kernel's passes, in
#: this process
launches = 0

#: the largest chunk the kernel runs at, one staged tile of rows: the
#: SSD's result does not depend on the chunking, only its work does (each
#: chunk's quadratic form is L·L, its state terms L·P·N), so the kernel
#: splits the caller's chunk
INNER_CHUNK = 64
#: largest caller's chunk, head dim P and state dim N the wrapper takes
MAX_CHUNK = 256
MAX_DIM = 64
#: the passes' C entry points, in launch order
PASSES = ("repro_ssd_chunk_state_f32", "repro_ssd_state_pass_f32",
          "repro_ssd_chunk_out_f32")


@torch.library.custom_op("repro_torch::mamba2_ssd", mutates_args=(),
                         device_types="cpu")
def mamba2_ssd(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """xdt[B, S, H, P], da[B, S, H], bm/cm[B, S, H, N] → [B, S, H, P]."""
    return ssd_ref(xdt, da, bm, cm)


@torch.library.custom_op("repro_torch::mamba2_ssd_state", mutates_args=(),
                         device_types="cpu")
def mamba2_ssd_state(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba2_ssd` and the state after the last step [B, H, P, N]
    (float32 at least)."""
    return ssd_state_ref(xdt, da, bm, cm)


def inner_chunk(chunk: int) -> int:
    """The chunk the kernel runs at for a caller's ``chunk``: its largest
    divisor up to ``INNER_CHUNK``."""
    return next(d for d in range(min(chunk, INNER_CHUNK), 0, -1)
                if chunk % d == 0)


def pass_calls(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, chunk: int,
               final: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, List[Tuple[str, Callable[[], None]]]]:
    """Check the operands and allocate the output and the scratch
    (``states`` [B, S/L, H, P, N] and ``decay`` [B, S/L, H], f32, L =
    ``inner_chunk(chunk)``);
    return the output and, per pass in launch order, its C entry point's
    name and a call that launches it on the current stream (raising on a
    launch error).  Calling them in order computes the output, and with
    ``final`` (f32 [B, H, P, N]) pass (b) also writes the state after the
    last chunk there."""
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
    dev = xdt.device
    inner = inner_chunk(chunk)
    out = torch.empty_like(xdt)
    states = torch.empty((b, s // inner, h, p, n), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((b, s // inner, h), dtype=torch.float32, device=dev)
    dims = (b, s, h, p, n, inner)

    if final is not None and (
            final.shape != (b, h, p, n) or final.dtype != torch.float32
            or not final.is_contiguous() or final.device != dev):
        raise ValueError(f"mamba2_ssd: final state must be a contiguous "
                         f"float32 [{b}, {h}, {p}, {n}] on {dev}")

    def launch(name, *tensors):   # holds its tensors, scratch included
        return name, lambda: _build.launch_on(
            dev, name, *(0 if t is None else t.data_ptr() for t in tensors),
            *dims)
    calls = [launch(PASSES[0], xdt, da, bm, states, decay),
             launch(PASSES[1], states, decay, final),
             launch(PASSES[2], xdt, da, bm, cm, states, out)]
    return out, calls


def mamba2_ssd_cuda(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                    cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Check the operands, launch the three passes of
    ``csrc/mamba2_ssd.cu`` in order, count the call."""
    global launches
    out, calls = pass_calls(xdt, da, bm, cm, chunk)
    for _, launch in calls:
        launch()
    launches += 1
    return out


def mamba2_ssd_state_cuda(xdt: torch.Tensor, da: torch.Tensor,
                          bm: torch.Tensor, cm: torch.Tensor, chunk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the three passes with pass (b) writing the state after the
    last chunk; count the call.  Returns (y, state [B, H, P, N], f32)."""
    global launches
    b, _, h, p = xdt.shape
    final = torch.empty((b, h, p, bm.shape[-1]), dtype=torch.float32,
                        device=xdt.device)
    out, calls = pass_calls(xdt, da, bm, cm, chunk, final)
    for _, launch in calls:
        launch()
    launches += 1
    return out, final


@mamba2_ssd.register_fake
def _mamba2_ssd_fake(xdt, da, bm, cm, chunk):
    return torch.empty_like(xdt)


@mamba2_ssd_state.register_fake
def _mamba2_ssd_state_fake(xdt, da, bm, cm, chunk):
    b, _, h, p = xdt.shape
    return torch.empty_like(xdt), xdt.new_empty(
        (b, h, p, bm.shape[-1]),
        dtype=torch.promote_types(xdt.dtype, torch.float32))


class Mamba2SSD(torch.autograd.Function):
    """The card's SSD under autograd: the forward kernel, and a backward
    that raises until a backward kernel exists."""

    @staticmethod
    def forward(ctx, xdt, da, bm, cm, chunk):
        return mamba2_ssd_cuda(xdt, da, bm, cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "mamba2_ssd backward kernel: ROADMAP queue B (the card trains "
            "no Mamba-2 block yet)")


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:4])


def _backward(ctx, dy):
    return (*plain_vjp(ssd_ref, ctx.saved_tensors, dy), None)


mamba2_ssd.register_autograd(_backward, setup_context=_setup_context)
