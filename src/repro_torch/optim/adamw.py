"""AdamW with cosine schedule, global-norm clipping, and dtype-configurable
moments — the counterpart of ``repro.optim.adamw``.

Optimizer state is a plain tree mirroring the parameter tree.  The
arithmetic is the reference's: each update in float32, then cast to the
parameter dtype and to ``moment_dtype``; weight decay on tensors of two
or more dimensions only.  Unlike the reference (pure functions of
immutable arrays), :func:`apply_updates` writes the new values into the
parameter and moment tensors it is given — a model whose optimizer state
is most of the card's memory cannot hold a second copy — and works
through each tensor in slices of ``CHUNK`` elements, so its float32
temporaries stay small beside a 0.9 B-element embedding.  Elementwise
arithmetic does not depend on the slicing.

``opt_state_axes`` (the sharding rules' tree) waits for the mesh
(ROADMAP queue A item 5).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.param import torch_dtype, tree_leaves, tree_map

#: elements of one tensor updated at a time
CHUNK = 1 << 26


class OptState(NamedTuple):
    mu: Any               # first moment  (param-tree shaped)
    nu: Any               # second moment (param-tree shaped)
    count: torch.Tensor   # scalar int32 step


def init_opt_state(params: Any, ocfg: OptimizerConfig) -> OptState:
    mdt = torch_dtype(ocfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def abstract_opt_state(abstract_params: Any,
                       ocfg: OptimizerConfig) -> OptState:
    """Shapes and dtypes of the state, as ``meta`` tensors."""
    mdt = torch_dtype(ocfg.moment_dtype)

    def meta(p):
        return torch.empty(p.shape, dtype=mdt, device="meta")
    return OptState(mu=tree_map(meta, abstract_params),
                    nu=tree_map(meta, abstract_params),
                    count=torch.empty((), dtype=torch.int32, device="meta"))


def lr_schedule(ocfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to 10% of peak."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - ocfg.warmup_steps)
        / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return ocfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _slices(t: torch.Tensor):
    flat = t.reshape(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [sum(x.float().square().sum() for x in _slices(t))
              for t in tree_leaves(tree) if t.numel()]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _quantize_grads(grads: Any, mode: str) -> Any:
    """Gradient compression hook applied before the optimizer update.

    "bf16": cast (the default wire format already — documents intent)
    "int8": symmetric per-tensor int8 quantize/dequantize (lossy).
    """
    if mode == "none":
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    if mode == "int8":
        def q(g):
            gf = g.float()
            scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
            qi = torch.clamp(torch.round(gf / scale), -127, 127).to(
                torch.int8)
            return qi.float() * scale
        return tree_map(q, grads)
    raise ValueError(mode)


@torch.no_grad()
def apply_updates(
    params: Any,
    grads: Any,
    state: OptState,
    ocfg: OptimizerConfig,
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes the new parameters and moments into the
    tensors of ``params`` and ``state`` (each must be contiguous) and
    returns those trees with the new count, and the metrics ``grad_norm``
    (before clipping) and ``lr``."""
    grads = _quantize_grads(grads, ocfg.grad_compression)
    gnorm = global_norm(grads)
    clip = torch.clamp(ocfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    count = state.count + 1
    cf = count.float()
    lr = lr_schedule(ocfg, count)
    bc1 = 1.0 - ocfg.b1 ** cf
    bc2 = 1.0 - ocfg.b2 ** cf

    def upd(p, g, m, v):
        decay = p.dim() >= 2   # decoupled weight decay on matrices only
        for ps, gs, ms, vs in zip(*map(_slices, (p, g.to(p.device), m, v))):
            gf = gs.float() * clip
            m_new = ocfg.b1 * ms.float() + (1 - ocfg.b1) * gf
            v_new = ocfg.b2 * vs.float() + (1 - ocfg.b2) * gf * gf
            mhat = m_new / bc1
            vhat = v_new / bc2
            step_ = mhat / (torch.sqrt(vhat) + ocfg.eps)
            if decay:
                step_ = step_ + ocfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * step_)
            ms.copy_(m_new)
            vs.copy_(v_new)

    for p, g, m, v in zip(*map(tree_leaves, (params, grads, state.mu,
                                              state.nu))):
        if not all(t.is_contiguous() for t in (p, m, v)):
            raise ValueError("apply_updates updates contiguous parameter "
                             "and moment tensors in place")
        upd(p, g, m, v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.mu, state.nu, count), metrics
