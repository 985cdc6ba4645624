"""Mixture-of-experts FFN with sort-based capacity dispatch (GShard-style)
— the counterpart of ``repro.models.moe``.

Dispatch (static shapes, as the reference):
  1. router logits → softmax (float32) → top-k gates + expert ids
  2. flatten to ``T*k`` assignments, stable-sort by expert id
  3. rank within expert via ``searchsorted``; drop ranks ≥ capacity
  4. scatter kept tokens into ``[E*C, d]`` buffers (``index_add_``), run
     the experts batched,
  5. gather back and combine with gate weights.

Top-k breaks ties toward the lower expert id, as ``lax.top_k`` does.
Aux loss: Switch-style load balancing (mean router prob × mean
assignment fraction × E).  ``moe_impl="a2a"`` takes the expert-parallel
all-to-all dispatch of :mod:`repro_torch.models.moe_a2a` (which, as the
reference's, falls back to this scatter without a "model" mesh axis).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers
from repro_torch.models.param import ParamSpec
from repro_torch.sharding import shard_act


def _capacity(num_tokens: int, m: MoEConfig) -> int:
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    # round up to a lane-friendly multiple
    return max(8, -(-c // 8) * 8)


def moe_schema(cfg: ModelConfig) -> Dict:
    m = cfg.moe
    D, F_, E = cfg.d_model, m.d_ff_expert, m.num_experts
    sch: Dict = {
        "router": ParamSpec((D, E), ("embed", None), init="small_normal"),
        "w_gate": ParamSpec((E, D, F_), ("experts", "embed", "expert_ff")),
        "w_up": ParamSpec((E, D, F_), ("experts", "embed", "expert_ff")),
        "w_down": ParamSpec((E, F_, D), ("experts", "expert_ff", "embed")),
    }
    if m.num_shared_experts > 0:
        fs = m.d_ff_shared * m.num_shared_experts
        sch["shared"] = {
            "w_gate": ParamSpec((D, fs), ("embed", "ff")),
            "w_up": ParamSpec((D, fs), ("embed", "ff")),
            "w_down": ParamSpec((fs, D), ("ff", "embed")),
        }
    if m.dense_residual_d_ff > 0:
        sch["dense"] = {
            "w_gate": ParamSpec((D, m.dense_residual_d_ff), ("embed", "ff")),
            "w_up": ParamSpec((D, m.dense_residual_d_ff), ("embed", "ff")),
            "w_down": ParamSpec((m.dense_residual_d_ff, D), ("ff", "embed")),
        }
    return sch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, largest first, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: Dict, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x: [B, S, D] → (y, aux).  aux carries the load-balancing loss."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    C = _capacity(T, m)
    dev = x.device
    xf = x.reshape(T, D)

    # ----- routing (float32) ---------------------------------------------
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)              # [T, E]
    gate_vals, eidx = top_k(probs, K)                  # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style aux loss.
    me = probs.mean(0)                                 # mean router prob
    assign = F.one_hot(eidx, E).float().sum(1).mean(0)  # fraction routed
    aux_loss = E * torch.sum(me * assign)

    # ----- sort-based dispatch -------------------------------------------
    e_flat = eidx.reshape(-1)                          # [T*K]
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    g_flat = gate_vals.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted, t_sorted, g_sorted = e_flat[order], t_flat[order], \
        g_flat[order]
    start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                               side="left")           # [E]
    rank = torch.arange(T * K, device=dev) - start[e_sorted]
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank,
                       torch.full_like(rank, E * C))  # E*C = dropped bin

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, xf[t_sorted])
    buf = buf[: E * C].reshape(E, C, D)
    buf = shard_act(buf, "experts", "expert_cap", "act_embed")

    # ----- expert computation (batched over E) -----------------------------
    up = torch.bmm(buf, p["w_up"].to(x.dtype))
    gate = layers._act(cfg.activation, torch.bmm(buf, p["w_gate"].to(x.dtype)))
    h = shard_act(gate * up, "experts", "expert_cap", None)
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype))
    out_buf = shard_act(out_buf, "experts", "expert_cap", "act_embed")

    # ----- combine ---------------------------------------------------------
    out_flat = out_buf.reshape(E * C, D)
    slot_cl = torch.clamp(slot, max=E * C - 1)
    contrib = out_flat[slot_cl] * (keep * g_sorted)[:, None].to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev)
    y.index_add_(0, t_sorted, contrib)
    y = y.reshape(B, S, D)

    # ----- shared experts / dense residual (always-on branches) -----------
    if m.num_shared_experts > 0:
        y = y + layers.apply_mlp(p["shared"], cfg, x)
    if m.dense_residual_d_ff > 0:
        y = y + layers.apply_mlp(p["dense"], cfg, x)

    frac_dropped = 1.0 - keep.float().mean()
    return shard_act(y, "batch", "seq", "act_embed"), {
        "moe_aux_loss": aux_loss * m.aux_loss_weight,
        "moe_frac_dropped": frac_dropped}


# ---------------------------------------------------------------------------
# Full MoE transformer layer: attention + MoE FFN
# ---------------------------------------------------------------------------


def moe_layer_schema(cfg: ModelConfig) -> Dict:
    sch = {
        "ln_attn": layers.norm_schema(cfg),
        "attn": layers.mla_schema(cfg) if cfg.attention.kind == "mla"
        else layers.attn_schema(cfg),
        "ln_mlp": layers.norm_schema(cfg),
        "moe": moe_schema(cfg),
    }
    if dict(cfg.extra).get("post_norm", False):
        sch["ln_attn_post"] = layers.norm_schema(cfg)
        sch["ln_mlp_post"] = layers.norm_schema(cfg)
    return sch


def moe_layer_cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    return layers.attn_mlp_cache_schema(cfg, batch, seq)


def apply_moe_layer(
    p: Dict, x: torch.Tensor, ctx: layers.Ctx, cache: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    cfg = ctx.cfg
    new_cache: Dict = {}
    h = layers.apply_norm(p["ln_attn"], cfg, x)
    if cfg.attention.kind == "mla":
        y, c = layers.apply_mla(p["attn"], h, ctx,
                                cache.get("attn") if cache else None)
    else:
        y, c = layers.apply_attn(p["attn"], h, ctx,
                                 cache.get("attn") if cache else None)
    if c is not None:
        new_cache["attn"] = c
    x = x + y
    h = layers.apply_norm(p["ln_mlp"], cfg, x)
    if ctx.moe_impl == "a2a":
        from repro_torch.models.moe_a2a import apply_moe_a2a
        y, aux = apply_moe_a2a(p["moe"], cfg, h)
    else:
        y, aux = apply_moe(p["moe"], cfg, h)
    x = x + y
    return x, (new_cache if cache is not None else None), aux
