"""Step factories: train_step (with gradient accumulation), prefill,
decode — the counterpart of ``repro.launch.steps``.

The reference jits these; the port runs them eagerly.  Parameters are
leaf tensors with ``requires_grad``; a train step takes the gradient of
the loss over the parameter tree with ``torch.autograd.grad`` and applies
:func:`repro_torch.optim.adamw.apply_updates`, which updates the
parameter and moment tensors in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import lm
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import adamw


def make_loss_fn(run: RunConfig):
    cfg = run.model

    def loss_fn(params, batch):
        return lm.lm_loss(
            params, cfg, batch, remat=run.remat, attn_impl=run.attn_impl,
            moe_impl=run.moe_impl)

    return loss_fn


def value_and_grad(loss_fn, params: Any, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: the gradient
    of every parameter leaf (zeros for one the loss does not reach), in
    the parameter tree's structure, loss and metrics detached."""
    loss, metrics = loss_fn(params, batch)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _microbatches(v: torch.Tensor, M: int) -> torch.Tensor:
    """``v`` [B, ...] as [M, B/M, ...], microbatch i rows i·B/M onwards.
    A DTensor sharded on its batch keeps each microbatch sharded so
    (DTensor does not split a sharded dimension it cannot divide by the
    mesh): gathered, split, then each rank keeps its block of every
    microbatch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = (M, v.shape[0] // M, *v.shape[1:])
    if not isinstance(v, DTensor):
        return v.reshape(shape)
    mesh = v.device_mesh
    whole = v.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(shape)
    return whole.redistribute(mesh, [Shard(p.dim + 1) if p.is_shard() else p
                                     for p in v.placements])


def make_train_step(run: RunConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics).

    With ``run.microbatches > 1`` the global batch is split along axis 0
    and the gradients are accumulated in the parameter dtype, as the
    reference's scan accumulates them; loss and metrics are averaged over
    the microbatches."""
    loss_fn = make_loss_fn(run)
    M = run.microbatches

    def train_step(params, opt_state, batch):
        if M == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            mb = {k: _microbatches(v, M) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            rows = []
            for i in range(M):
                l, mtr, g = value_and_grad(loss_fn, params,
                                           {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.to(acc.dtype))
                del g
                loss = loss + l
                rows.append(mtr)
            grads = tree_map(lambda g: g / M, grads)
            loss = loss / M
            metrics = {k: torch.stack([r[k] for r in rows]).mean(dim=0)
                       for k in rows[0]}

        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, run.optimizer)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(run: RunConfig):
    cfg = run.model

    def prefill_step(params, cache, batch):
        return lm.prefill(params, cfg, cache, batch, attn_impl=run.attn_impl,
                          q_chunk=run.q_chunk, kv_chunk=run.kv_chunk,
                          moe_impl=run.moe_impl)

    return prefill_step


def make_decode_step(run: RunConfig):
    cfg = run.model

    def decode_step(params, cache, tokens, cur_index):
        return lm.decode_step(params, cfg, cache, tokens, cur_index,
                              moe_impl=run.moe_impl)

    return decode_step
