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

Gradients: on the card :class:`Mamba2SSD` runs the forward kernel and
its backward launches ``csrc/mamba2_ssd_bwd.cu``
(``mamba2_ssd_bwd_cuda``: the forward's passes (a) and (b) again into
scratch, then the backward's three passes).  On the host the custom
op's autograd calls the custom op ``repro_torch::mamba2_ssd_bwd``,
whose CPU impl is the same algorithm in PyTorch (``ref.ssd_bwd_ref``)
and whose fake impl lets the counter price a training step.  The
reference has no backward kernel: it differentiates its jnp scan.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref, ssd_state_ref

#: calls of ``mamba2_ssd_cuda`` that launched the kernel's passes, in
#: this process
launches = 0
#: calls of ``mamba2_ssd_bwd_cuda`` (each launches the forward's passes
#: (a), (b) and the backward's three) in this process
backward_launches = 0

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
#: the backward's own passes' C entry points, in launch order (after the
#: forward's first two)
BWD_PASSES = ("repro_ssd_chunk_state_grad_f32",
              "repro_ssd_state_grad_pass_f32", "repro_ssd_chunk_grad_f32")


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


def _check(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
           cm: torch.Tensor, chunk: int, *more: torch.Tensor) -> None:
    """Raise on operands the kernels do not take (``more``: the output
    gradient of the backward, shaped as xdt)."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    if any(t.dtype != torch.float32 for t in (xdt, da, bm, cm, *more)):
        raise TypeError(f"mamba2_ssd takes float32, got "
                        f"{[t.dtype for t in (xdt, da, bm, cm, *more)]}")
    if da.shape != (b, s, h) or bm.shape != (b, s, h, n) \
            or cm.shape != bm.shape or s % chunk \
            or any(t.shape != xdt.shape for t in more):
        raise ValueError(f"mamba2_ssd: shapes "
                         f"{[tuple(t.shape) for t in (xdt, da, bm, cm, *more)]}"
                         f" with chunk={chunk}")
    if p > MAX_DIM or n > MAX_DIM or chunk > MAX_CHUNK:
        raise ValueError(f"mamba2_ssd kernel takes P, N <= {MAX_DIM} and "
                         f"chunk <= {MAX_CHUNK}, got P={p}, N={n}, "
                         f"chunk={chunk}")
    if not all(t.is_contiguous() for t in (xdt, da, bm, cm, *more)):
        raise ValueError("mamba2_ssd takes contiguous operands")
    if any(t.device != xdt.device for t in (da, bm, cm, *more)):
        raise ValueError("mamba2_ssd operands must share one device")


def _launcher(dev, dims):
    """``launch(name, *tensors)`` → (name, a call launching C entry point
    ``name`` on the current stream with the tensors' pointers (0 for
    None) and ``dims``); the call holds its tensors, scratch included."""
    def launch(name, *tensors):
        return name, lambda: _build.launch_on(
            dev, name, *(0 if t is None else t.data_ptr() for t in tensors),
            *dims)
    return launch


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
    _check(xdt, da, bm, cm, chunk)
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    dev = xdt.device
    if final is not None and (
            final.shape != (b, h, p, n) or final.dtype != torch.float32
            or not final.is_contiguous() or final.device != dev):
        raise ValueError(f"mamba2_ssd: final state must be a contiguous "
                         f"float32 [{b}, {h}, {p}, {n}] on {dev}")
    inner = inner_chunk(chunk)
    out = torch.empty_like(xdt)
    states = torch.empty((b, s // inner, h, p, n), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((b, s // inner, h), dtype=torch.float32, device=dev)
    launch = _launcher(dev, (b, s, h, p, n, inner))
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


def mamba2_ssd_bwd_cuda(xdt: torch.Tensor, da: torch.Tensor,
                        bm: torch.Tensor, cm: torch.Tensor, dy: torch.Tensor,
                        chunk: int) -> Tuple[torch.Tensor, ...]:
    """Check the operands, launch the forward's passes (a) and (b) again
    (the state before each chunk, into scratch) and the three passes of
    ``csrc/mamba2_ssd_bwd.cu`` (each chunk's own state gradient, the
    reverse pass along the chunks, each chunk's gradients) at the
    kernel's chunk; count the call.  Returns (dxdt, dda, dB, dC)."""
    global backward_launches
    _check(xdt, da, bm, cm, chunk, dy)
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    inner = inner_chunk(chunk)
    scratch = (b, s // inner, h, p, n)
    states = torch.empty(scratch, dtype=torch.float32, device=xdt.device)
    grads = torch.empty(scratch, dtype=torch.float32, device=xdt.device)
    decay = torch.empty(scratch[:3], dtype=torch.float32, device=xdt.device)
    out = tuple(torch.empty_like(t) for t in (xdt, da, bm, cm))
    launch = _launcher(xdt.device, (b, s, h, p, n, inner))
    for _, call in (launch(PASSES[0], xdt, da, bm, states, decay),
                    launch(PASSES[1], states, decay, None),
                    launch(BWD_PASSES[0], dy, da, cm, grads),
                    launch(BWD_PASSES[1], grads, decay),
                    launch(BWD_PASSES[2], xdt, da, bm, cm, dy, states,
                           grads, *out)):
        call()
    backward_launches += 1
    return out


@torch.library.custom_op("repro_torch::mamba2_ssd_bwd", mutates_args=(),
                         device_types="cpu")
def mamba2_ssd_bwd(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, dy: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The gradient of ``repro_torch::mamba2_ssd``: (dxdt, dda, dB, dC)
    for the output gradient ``dy``, by the backward kernel's algorithm in
    PyTorch."""
    return ssd_bwd_ref(xdt, da, bm, cm, dy, chunk)


@mamba2_ssd_bwd.register_fake
def _mamba2_ssd_bwd_fake(xdt, da, bm, cm, dy, chunk):
    return tuple(torch.empty_like(t) for t in (xdt, da, bm, cm))


class Mamba2SSD(torch.autograd.Function):
    """The card's SSD under autograd: the forward kernel, and the
    backward kernel as its backward."""

    @staticmethod
    def forward(ctx, xdt, da, bm, cm, chunk):
        ctx.save_for_backward(xdt, da, bm, cm)
        ctx.chunk = chunk
        return mamba2_ssd_cuda(xdt, da, bm, cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        return (*mamba2_ssd_bwd_cuda(*ctx.saved_tensors, dy.contiguous(),
                                     ctx.chunk), None)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:4])
    ctx.chunk = inputs[4]


def _backward(ctx, dy):
    return (*mamba2_ssd_bwd(*ctx.saved_tensors, dy.contiguous(), ctx.chunk),
            None)


mamba2_ssd.register_autograd(_backward, setup_context=_setup_context)
