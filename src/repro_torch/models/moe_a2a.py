"""Expert-parallel MoE dispatch by all-to-all — the counterpart of
``repro.models.moe_a2a``.

The baseline ``apply_moe`` scatters tokens into a global ``[E, C, D]``
buffer, which under a mesh gathers the activations and the experts'
weights.  This path is the production layout (GShard/Switch):

  1. tokens are sharded over BOTH the dp axes and the EP ("model") axis —
     each rank routes its own T_loc tokens,
  2. each rank buckets its tokens by *destination EP rank* (the rank
     owning the target expert) into fixed-capacity send buffers
     ``[ep, C_pair, D]``,
  3. one all-to-all over the EP axis delivers every token to its
     expert's owner; a local sort buckets by local expert,
  4. local expert FFN ``[E_loc, C_loc, D]``,
  5. the reverse all-to-all returns outputs; gates are applied locally,
     and the EP ranks' token slices are gathered back into the block.

The reference runs the body under ``shard_map``; here each rank runs it
on its local blocks (``DTensor.to_local``) over the mesh's "model"
subgroup, with autograd's all-to-all (``torch.distributed.nn``) and
DTensor's redistribution for the gather, so the backward moves the
gradients the same way back.  Each local block declares where its
gradient lives: a token block replicated over "model" sums its ranks'
gradients (each used its own slice), expert weights replicated over the
dp axes sum theirs.  ``pmean`` over "model" and the dp axes is a
partial sum, divided, made replicated.

Without a "model" axis, or when the expert count does not divide it, the
reference's semantics fall back to ``apply_moe``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import current_mesh, mesh_shape


def _ep_axis(mesh) -> Optional[str]:
    return "model" if mesh is not None and "model" in mesh_shape(mesh) \
        else None


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _placements(mesh, dp, ep):
    """One placement per mesh dimension: ``dp`` on the dp axes, ``ep`` on
    the "model" axis."""
    return [ep if a == "model" else dp for a in mesh_shape(mesh)]


def _pmean(value: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``value`` over every rank of ``mesh``, as a replicated
    DTensor (differentiable: each rank's gradient is the mean's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    n = mesh.size()
    part = DTensor.from_local(value / n, mesh, [Partial()] * mesh.ndim,
                              run_check=False)
    return part.redistribute(mesh, [Replicate()] * mesh.ndim)


def apply_moe_a2a(p: Dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict]:
    """Drop-in replacement for ``apply_moe`` on a (pod, data, model)
    mesh: ``x`` [B, S, D] and the parameters DTensors on it."""
    from repro_torch.models import moe as _moe
    mesh = current_mesh()
    ep = _ep_axis(mesh)
    if ep is None or cfg.moe.num_experts % mesh_shape(mesh)[ep] != 0:
        return _moe.apply_moe(p, cfg, x)

    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m = cfg.moe
    B, S, D = x.shape
    n_ep = mesh_shape(mesh)[ep]
    E_loc = m.num_experts // n_ep
    dp = _dp_axes(mesh)
    n_dp = mesh.size() // n_ep
    if B % n_dp:
        raise ValueError(f"apply_moe_a2a: batch {B} does not split over the "
                         f"{n_dp} data-parallel ranks")
    group = mesh.get_group(ep)
    ep_rank = mesh.get_local_rank(ep)

    def local(t, placements, grads):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local(grad_placements=grads)

    # x: [B_loc, S, D], the same on every EP rank; each takes its slice
    x_blk = local(x, _placements(mesh, Shard(0), Replicate()),
                  _placements(mesh, Shard(0), Partial()))
    rep, part = [Replicate()] * mesh.ndim, [Partial()] * mesh.ndim
    router = local(p["router"], rep, part)
    w_gate, w_up, w_down = (
        local(p[k], _placements(mesh, Replicate(), Shard(0)),
              _placements(mesh, Partial(), Shard(0)))
        for k in ("w_gate", "w_up", "w_down"))

    Bl = x_blk.shape[0]
    T_all = Bl * S
    # pad the token count to an EP multiple (decode batches can be tiny)
    T_pad = -(-T_all // n_ep) * n_ep
    xf = x_blk.reshape(T_all, D)
    if T_pad != T_all:
        xf = F.pad(xf, (0, 0, 0, T_pad - T_all))
    T_loc = T_pad // n_ep
    x_my = xf[ep_rank * T_loc:(ep_rank + 1) * T_loc]
    dev = x_my.device

    # ----- local routing --------------------------------------------------
    logits = x_my.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                 # [T_loc, E]
    gate_vals, eidx = _moe.top_k(probs, m.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(0)
    assign = F.one_hot(eidx, m.num_experts).float().sum(1).mean(0)
    aux = _pmean(m.num_experts * torch.sum(me * assign), mesh)

    # ----- bucket by destination EP rank ---------------------------------
    K = m.top_k
    e_flat = eidx.reshape(-1)                             # [T_loc*K]
    dst = e_flat // E_loc                                 # owning EP rank
    t_flat = torch.arange(T_loc, device=dev).repeat_interleave(K)
    g_flat = gate_vals.reshape(-1)
    order = torch.argsort(dst, stable=True)
    dst_s, e_s, t_s, g_s = dst[order], e_flat[order], t_flat[order], \
        g_flat[order]
    # capacity per (src, dst) pair
    C_pair = max(8, -(-int(T_loc * K * m.capacity_factor / n_ep) // 8) * 8)
    start = torch.searchsorted(dst_s, torch.arange(n_ep, device=dev),
                               side="left")
    rank_in = torch.arange(T_loc * K, device=dev) - start[dst_s]
    keep = rank_in < C_pair
    slot = torch.where(keep, dst_s * C_pair + rank_in,
                       torch.full_like(rank_in, n_ep * C_pair))

    send_x = torch.zeros((n_ep * C_pair + 1, D), dtype=x_blk.dtype,
                         device=dev).index_add(0, slot, x_my[t_s])
    send_e = torch.full((n_ep * C_pair + 1,), -1, dtype=torch.long,
                        device=dev)
    send_e[slot] = e_s
    send_x = send_x[:-1].reshape(n_ep, C_pair, D)
    send_e = send_e[:-1].reshape(n_ep, C_pair).contiguous()

    # ----- all-to-all: deliver to expert owners ---------------------------
    recv_x = dnn.all_to_all_single(torch.empty_like(send_x), send_x,
                                   group=group)
    recv_e = torch.empty_like(send_e)
    dist.all_to_all_single(recv_e, send_e, group=group)
    del send_x, send_e   # each buffer is T·k·cf rows: free them early
    # recv_*: [n_ep(src), C_pair, D] — tokens for MY experts

    # ----- local bucketing by local expert --------------------------------
    R = n_ep * C_pair
    rx = recv_x.reshape(R, D)
    re = recv_e.reshape(R)
    le = torch.where(re >= 0, re - ep_rank * E_loc,
                     torch.full_like(re, E_loc))           # local expert id
    order2 = torch.argsort(le, stable=True)
    le_s = le[order2]
    C_loc = max(8, -(-int(R * 2 / max(E_loc, 1)) // 8) * 8)
    start2 = torch.searchsorted(le_s, torch.arange(E_loc, device=dev),
                                side="left")
    rank2 = torch.arange(R, device=dev) - start2[torch.clamp(le_s,
                                                             max=E_loc - 1)]
    keep2 = (le_s < E_loc) & (rank2 < C_loc)
    slot2 = torch.where(keep2, le_s * C_loc + rank2,
                        torch.full_like(rank2, E_loc * C_loc))
    buf = torch.zeros((E_loc * C_loc + 1, D), dtype=x_blk.dtype,
                      device=dev).index_add(0, slot2, rx[order2])
    buf = buf[:-1].reshape(E_loc, C_loc, D)

    # ----- expert FFN (local weights) --------------------------------------
    up = torch.bmm(buf, w_up.to(buf.dtype))
    gate = layers._act(cfg.activation, torch.bmm(buf, w_gate.to(buf.dtype)))
    out_buf = torch.bmm(gate * up, w_down.to(buf.dtype))
    del buf, up, gate, recv_x, rx

    # ----- un-bucket + reverse all-to-all ----------------------------------
    out_flat = out_buf.reshape(E_loc * C_loc, D)
    contrib = out_flat[torch.clamp(slot2, max=E_loc * C_loc - 1)] \
        * keep2[:, None].to(out_flat.dtype)
    back = torch.zeros((R, D), dtype=x_blk.dtype, device=dev).index_add(
        0, order2, contrib).reshape(n_ep, C_pair, D)
    ret_x = dnn.all_to_all_single(torch.empty_like(back), back, group=group)
    del out_buf, out_flat, contrib, back
    # ret_x: [n_ep(dst), C_pair, D] — this rank's tokens, back home

    # ----- combine with gates ------------------------------------------------
    ret_flat = ret_x.reshape(n_ep * C_pair, D)
    gathered = ret_flat[torch.clamp(slot, max=n_ep * C_pair - 1)] \
        * (keep * g_s)[:, None].to(x_blk.dtype)
    y_my = torch.zeros((T_loc, D), dtype=x_blk.dtype, device=dev).index_add(
        0, t_s, gathered)

    frac_dropped = _pmean(1.0 - keep.float().mean(), mesh)

    # reassemble the local token block across EP ranks: the global
    # [n_dp·T_pad, D] is sharded over the dp axes, then over "model"
    y_all = DTensor.from_local(
        y_my, mesh, _placements(mesh, Shard(0), Shard(0)), run_check=False,
    ).redistribute(mesh, _placements(mesh, Shard(0), Replicate())).to_local()
    y = DTensor.from_local(y_all[:T_all].reshape(Bl, S, D), mesh,
                           _placements(mesh, Shard(0), Replicate()),
                           run_check=False)

    if m.num_shared_experts > 0:
        y = y + layers.apply_mlp(p["shared"], cfg, x)
    if m.dense_residual_d_ff > 0:
        y = y + layers.apply_mlp(p["dense"], cfg, x)
    return y, {"moe_aux_loss": aux * m.aux_loss_weight,
               "moe_frac_dropped": frac_dropped}
