"""LM assembly: schema → init → forward / loss / prefill / decode — the
counterpart of ``repro.models.lm``.

One generic assembly covers all ten architectures:

  * decoder-only dense / MoE / hybrid / SSM stacks (a loop over groups)
  * zamba2-style *shared* attention block re-invoked every group
  * whisper-style encoder-decoder (separate bidirectional encoder stack)
  * modality frontends as stubs (precomputed embeddings, projected in)

The reference scans its stacked body; the port loops over the leading
"layers" axis of the same stacked parameters (and caches).  In training
(``mode="train"`` with autograd on) each group runs under
``torch.utils.checkpoint`` as ``remat`` says — ``full`` recomputes the
whole group in backward, ``dots`` keeps the outputs of its matrix
products (``aten.mm``/``addmm``, the counterpart of the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest; serving
has no remat.  Logits are computed at every position before ``prefill``
keeps the last one, as the reference does: at vocab 256000 that is
B·S·256000 activations to size a prompt by.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.blocks import (BLOCKS, aux_keys, effective_pattern,
                                       effective_prefix)
from repro_torch.models.param import (ParamSpec, axes_tree, init_stacked,
                                      init_tree, stack_schema, torch_dtype,
                                      tree_map)
from repro_torch.sharding import (embedding_lookup, gather_dp, shard_act,
                                  target_logits)


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def _group_schema(cfg: ModelConfig) -> Dict:
    return {
        f"b{i}": BLOCKS[bid].schema(cfg)
        for i, bid in enumerate(effective_pattern(cfg))
    }


def model_schema(cfg: ModelConfig) -> Dict:
    V, D = padded_vocab(cfg), cfg.d_model
    sch: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="small_normal"),
        "final_norm": layers.norm_schema(cfg),
    }
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    if cfg.frontend.kind != "none":
        sch["frontend_proj"] = ParamSpec(
            (cfg.frontend.d_frontend, D), ("frontend", "embed"))
    for i, bid in enumerate(effective_prefix(cfg)):
        sch[f"prefix_{i}"] = BLOCKS[bid].schema(cfg)
    sch["body"] = stack_schema(_group_schema(cfg), cfg.num_groups)
    if cfg.shared_attn_every:
        sch["shared_attn"] = layers.attn_mlp_schema(cfg)
    if cfg.encdec is not None:
        enc_group = {"b0": BLOCKS["bidir_attn_mlp"].schema(cfg)}
        sch["encoder"] = {
            "body": stack_schema(enc_group, cfg.encdec.num_encoder_layers),
            "final_norm": layers.norm_schema(cfg),
        }
    return sch


def cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """KV / state cache buffers for serving at max length ``seq``."""
    group: Dict[str, Any] = {}
    if cfg.shared_attn_every:
        group["shared"] = layers.attn_mlp_cache_schema(cfg, batch, seq)
    for i, bid in enumerate(effective_pattern(cfg)):
        c = BLOCKS[bid].cache_schema(cfg, batch, seq)
        if c:
            group[f"b{i}"] = c
    out: Dict[str, Any] = {"body": stack_schema(group, cfg.num_groups)}
    for i, bid in enumerate(effective_prefix(cfg)):
        c = BLOCKS[bid].cache_schema(cfg, batch, seq)
        if c:
            out[f"prefix_{i}"] = c
    return out


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    """Materialize parameters, drawn from ``gen`` on ``device`` (the
    generator's device when ``None``).  The draws are not the
    reference's: to compare with it, carry its weights
    (:func:`repro_torch.models.param.carry`)."""
    dtype = torch_dtype(cfg.param_dtype)
    sch = model_schema(cfg)
    body = sch.pop("body")
    out = init_tree(gen, sch, dtype, device)
    out["body"] = init_stacked(gen, _group_schema(cfg), cfg.num_groups,
                               dtype, device)
    sch["body"] = body
    return out


def abstract_params(cfg: ModelConfig) -> Dict:
    """The parameters' shapes and dtypes as ``meta`` tensors (nothing is
    allocated)."""
    dtype = torch_dtype(cfg.param_dtype)
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
        model_schema(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))


def param_axes(cfg: ModelConfig) -> Dict:
    """The parameters' logical-axis tuples, leaf for leaf."""
    return axes_tree(model_schema(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """The cache's shapes and dtypes as ``meta`` tensors, every leaf in
    the activation dtype."""
    dtype = torch_dtype(cfg.activation_dtype)
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
        cache_schema(cfg, batch, seq),
        is_leaf=lambda x: isinstance(x, ParamSpec))


def cache_axes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """The cache's logical-axis tuples, leaf for leaf."""
    return axes_tree(cache_schema(cfg, batch, seq))


def zero_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Dict:
    """Zeroed cache buffers, every leaf in the activation dtype (as the
    reference's)."""
    dtype = torch_dtype(cfg.activation_dtype)
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=dtype, device=device),
        cache_schema(cfg, batch, seq),
        is_leaf=lambda x: isinstance(x, ParamSpec))


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = embedding_lookup(gather_dp(params["embed"]), tokens)  # gather [B,S,D]
    if dict(cfg.extra).get("embed_scale", False):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x.to(torch_dtype(cfg.activation_dtype))


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ gather_dp(params["embed"]).to(x.dtype).T
    else:
        logits = x @ gather_dp(params["lm_head"]).to(x.dtype)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return shard_act(logits, "batch", "seq", "vocab")


def _index(tree: Dict, g: int) -> Dict:
    """Group ``g`` of a stacked tree (views)."""
    return tree_map(lambda t: t[g], tree)


class _Stacker:
    """Writes each group's new cache back into a stacked tree.  A leaf the
    block updated in place (a view of the stacked buffer) needs nothing;
    any other leaf goes into a stacked buffer of its own dtype, allocated
    at the first group — as a scan stacks its outputs."""

    def __init__(self, stacked: Dict, num: int):
        self.stacked, self.num, self.out = stacked, num, None

    def put(self, g: int, new: Dict) -> None:
        if self.out is None:
            self.out = tree_map(lambda t: None, new)
        self.out = self._put(self.out, self.stacked, new, g)

    def _put(self, out, stacked, new, g):
        if isinstance(new, dict):
            return {k: self._put(out[k], stacked.get(k) if stacked else None,
                                 v, g) for k, v in new.items()}
        buf = out
        if buf is None and stacked is not None \
                and stacked.dtype == new.dtype \
                and stacked.shape[1:] == new.shape:
            buf = stacked
        if buf is None:
            buf = new.new_empty((self.num, *new.shape))
        if buf[g].data_ptr() != new.data_ptr():
            buf[g].copy_(new)
        return buf


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor,
                 ctx_proto: layers.Ctx) -> torch.Tensor:
    """Whisper-style bidirectional encoder over stub frame embeddings."""
    enc = params["encoder"]
    B, T, _ = frames.shape
    x = frames @ gather_dp(params["frontend_proj"]).to(frames.dtype)
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    ctx = layers.Ctx(cfg=cfg, mode="train", positions=pos,
                     attn_impl=ctx_proto.attn_impl,
                     q_chunk=ctx_proto.q_chunk, kv_chunk=ctx_proto.kv_chunk)
    for g in range(cfg.encdec.num_encoder_layers):
        x, _, _ = BLOCKS["bidir_attn_mlp"].apply(
            gather_dp(_index(enc["body"], g)["b0"]), x, ctx, None)
    return layers.apply_norm(gather_dp(enc["final_norm"]), cfg, x)


def _apply_group(gp, x, ctx: layers.Ctx, gcache, shared_params,
                 cfg: ModelConfig, ak: Tuple[str, ...]):
    gp, shared_params = gather_dp(gp), gather_dp(shared_params)
    new_cache: Dict = {}
    aux = {k: torch.zeros((), device=x.device) for k in ak}
    if cfg.shared_attn_every:
        c = gcache.get("shared") if gcache else None
        x, cs, _ = layers.apply_attn_mlp(shared_params, x, ctx, c)
        if cs is not None:
            new_cache["shared"] = cs
    for i, bid in enumerate(effective_pattern(ctx.cfg)):
        c = gcache.get(f"b{i}") if gcache else None
        x, ci, a = BLOCKS[bid].apply(gp[f"b{i}"], x, ctx, c)
        if ci is not None:
            new_cache[f"b{i}"] = ci
        for k, v in a.items():
            aux[k] = aux[k] + v
    return x, (new_cache or None), aux


REMATS = ("none", "full", "dots")
#: the products ``dots`` keeps (matrix products without batch dims)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_call(fn, remat: str, *args):
    """``fn(*args)`` under activation checkpointing as ``remat`` says."""
    if remat == "none":
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def forward(
    params: Dict,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    cur_index: Optional[int] = None,
    remat: str = "full",
    attn_impl: str = "chunked_scan",
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    moe_impl: str = "scatter",
) -> Tuple[torch.Tensor, Dict, Optional[Dict]]:
    """Returns (logits, aux, new_cache).

    batch keys: "tokens" [B,St]; optional "frontend" [B,P,Df] (vlm prefix
    embeddings or whisper frames).  In decode mode tokens is [B,1] and
    ``cur_index`` is the write position.  ``remat`` (none | full | dots)
    applies to the body's groups in train mode with autograd on.
    """
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; known: {REMATS}")
    tokens = batch["tokens"]
    B, St = tokens.shape
    ak = aux_keys(cfg)
    dev = tokens.device

    enc_out = None
    if cfg.encdec is not None and mode != "decode":
        # decode reads cross K/V from the cache; the encoder runs at prefill
        enc_out = _run_encoder(
            params, cfg, batch["frontend"],
            layers.Ctx(cfg=cfg, mode=mode,
                       positions=torch.zeros((1, 1), dtype=torch.long,
                                             device=dev),
                       attn_impl=attn_impl, q_chunk=q_chunk,
                       kv_chunk=kv_chunk))

    x = _embed(params, cfg, tokens)
    n_front = 0
    if cfg.frontend.kind != "none" and cfg.encdec is None and mode != "decode":
        fe = batch["frontend"]
        fe = fe @ gather_dp(params["frontend_proj"]).to(fe.dtype)
        n_front = fe.shape[1]
        x = torch.cat([fe.to(x.dtype), x], dim=1)

    S = x.shape[1]
    if mode == "decode":
        positions = torch.full((B, 1), int(cur_index), dtype=torch.long,
                               device=dev)
    else:
        positions = torch.arange(S, device=dev)[None].expand(B, S)

    if cfg.encdec is not None and not cfg.attention.use_rope:
        x = x + layers.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    x = shard_act(x, "batch", "seq", "act_embed")

    ctx = layers.Ctx(cfg=cfg, mode=mode, positions=positions,
                     cur_index=cur_index, enc_out=enc_out,
                     attn_impl=attn_impl, q_chunk=q_chunk, kv_chunk=kv_chunk,
                     moe_impl=moe_impl)

    aux = {k: torch.zeros((), device=dev) for k in ak}
    new_cache: Dict = {}

    # ----- prefix blocks -----------------------------------------------------
    for i, bid in enumerate(effective_prefix(cfg)):
        c = cache.get(f"prefix_{i}") if cache else None
        x, ci, a = BLOCKS[bid].apply(gather_dp(params[f"prefix_{i}"]), x,
                                     ctx, c)
        if ci is not None:
            new_cache[f"prefix_{i}"] = ci
        for k, v in a.items():
            aux[k] = aux[k] + v

    # ----- the stacked body, one group at a time ------------------------------
    shared_params = params.get("shared_attn")
    body_cache = cache.get("body") if cache else None
    stacker = _Stacker(body_cache, cfg.num_groups) \
        if body_cache is not None else None
    if mode != "train" or body_cache is not None \
            or not torch.is_grad_enabled():
        remat = "none"

    def group(x, gp):
        x, _, a = _apply_group(gp, x, ctx, None, shared_params, cfg, ak)
        return x, a

    for g in range(cfg.num_groups):
        gp = _index(params["body"], g)
        if body_cache is None:
            x, a = _remat_call(group, remat, x, gp)
        else:
            x, gc_new, a = _apply_group(gp, x, ctx, _index(body_cache, g),
                                        shared_params, cfg, ak)
            stacker.put(g, gc_new)
        aux = {k: aux[k] + a[k] for k in ak}
    if stacker is not None:
        new_cache["body"] = stacker.out

    x = layers.apply_norm(gather_dp(params["final_norm"]), cfg, x)
    if n_front and mode != "decode":
        x = x[:, n_front:]  # logits only over text positions
    logits = _head(params, cfg, x)
    return logits, aux, (new_cache or None)


def lm_loss(params, cfg: ModelConfig, batch, *, remat: str = "full",
            attn_impl: str = "chunked_scan",
            moe_impl: str = "scatter") -> Tuple[torch.Tensor, Dict]:
    logits, aux, _ = forward(params, cfg, batch, mode="train", remat=remat,
                             attn_impl=attn_impl, moe_impl=moe_impl)
    targets = batch["targets"]
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = target_logits(lf, targets)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    nll = torch.sum((logz - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = nll
    metrics = {"nll": nll, **aux}
    if "moe_aux_loss" in aux:
        loss = loss + aux["moe_aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, cache, batch, *,
            attn_impl: str = "chunked_scan", q_chunk: int = 512,
            kv_chunk: int = 1024, moe_impl: str = "scatter"):
    """Forward the full prompt, filling the cache.  Returns (cache, logits
    at the last position)."""
    logits, _, new_cache = forward(
        params, cfg, batch, mode="prefill", cache=cache,
        attn_impl=attn_impl, q_chunk=q_chunk, kv_chunk=kv_chunk,
        moe_impl=moe_impl)
    return new_cache, logits[:, -1:]


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_index, *,
                batch_extras: Optional[Dict] = None,
                moe_impl: str = "scatter"):
    """One token step.  tokens: [B,1]; cur_index: the token's position."""
    batch = {"tokens": tokens}
    if batch_extras:
        batch.update(batch_extras)
    logits, _, new_cache = forward(
        params, cfg, batch, mode="decode", cache=cache,
        cur_index=int(cur_index), moe_impl=moe_impl)
    return new_cache, logits
