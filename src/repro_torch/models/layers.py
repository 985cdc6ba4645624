"""Core layer definitions: norms, RoPE, attention (GQA / local / MLA),
MLPs — the counterpart of ``repro.models.layers``.

* Pure functions over nested dicts of tensors built from ``ParamSpec``
  schemas (:mod:`repro_torch.models.param`), in the reference's layout.
* Every block is *residual-complete*: ``apply_*`` returns the full
  ``x + f(norm(x))`` value so the LM assembly simply chains blocks.
* Attention for train/prefill is :func:`repro_torch.kernels.ops.flash_attention`:
  on the card the hand kernel ``csrc/flash_attention.cu``, on the host
  its plain version.  It is called through the module attribute
  ``ops.flash_attention``, so a caller may wrap it.  The reference's
  ``attn_impl``/``q_chunk``/``kv_chunk`` pick how its own jnp attention is
  chunked; the port keeps them in its signatures, checks ``attn_impl``,
  and lowers every choice to the same kernel, which tiles for itself.
* Decode attention stays plain torch, as the reference's has no kernel.
* Softmax statistics are float32 regardless of activation dtype.  Where
  the reference asks a product of activation-dtype operands for a
  float32 result (``preferred_element_type``), the port computes it in
  the operands' dtype (float32 accumulation inside the GEMM) and widens
  the result: identical at float32.
* Caches: a served call writes its new keys and values into the cache's
  buffers and returns them; callers use the returned cache.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.param import ParamSpec, torch_dtype
from repro_torch.sharding import local_blocks, reshape, shard_act

NEG_INF = -1e30

#: the reference's two lowerings of its own attention; the port's kernel
#: serves both
ATTN_IMPLS = ("chunked_scan", "chunked_tri")


# ---------------------------------------------------------------------------
# Context threaded through every block
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                      # train | prefill | decode
    positions: torch.Tensor        # [B, S] absolute positions of the inputs
    cur_index: Optional[int] = None  # cache write offset (decode)
    enc_out: Optional[torch.Tensor] = None  # [B, T_enc, D] cross-attention
    attn_impl: str = "chunked_scan"        # chunked_scan | chunked_tri
    q_chunk: int = 512
    kv_chunk: int = 1024
    moe_impl: str = "scatter"              # scatter (a2a: ROADMAP item 5)

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; "
                             f"known: {ATTN_IMPLS}")

    @property
    def adt(self) -> torch.dtype:
        return torch_dtype(self.cfg.activation_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_schema(cfg: ModelConfig, dim: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = dim or cfg.d_model
    if cfg.norm == "layer":
        return {
            "scale": ParamSpec((d,), ("norm",), init="ones"),
            "bias": ParamSpec((d,), ("norm",), init="zeros"),
        }
    return {"scale": ParamSpec((d,), ("norm",), init="ones")}


def apply_norm(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(dt)


def rmsnorm_simple(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even), positions: [B, S] → rotated x."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs     # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings. positions: [B,S] → [B,S,d]."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _block(chunk: int, n: int) -> int:
    """A block of the reference's ``chunk`` that tiles ``n``, else all of
    ``n``: the wrapper's blocks only check tiling, the kernel picks its
    own tiles and takes ragged lengths."""
    b = min(chunk, n)
    return b if n % b == 0 else n


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    impl: str = "chunked_scan",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention through the hand kernel.  q: [B, Sq, Hq, Dk];
    k: [B, Skv, Hkv, Dk]; v: [B, Skv, Hkv, Dv]; GQA Hq = G·Hkv.  Returns
    [B, Sq, Hq, Dv] in q's dtype.  ``impl``, ``q_chunk`` and ``kv_chunk``
    are the reference's lowering choices: checked, not followed."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: "
                         f"{ATTN_IMPLS}")
    sq, skv = q.shape[1], k.shape[1]
    return ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, softcap=softcap, scale=scale,
        block_q=_block(q_chunk, sq), block_k=_block(kv_chunk, skv))


def _decode_softmax_pv(q, k_cache, v_cache, valid, *, softcap, scale):
    B, _, Hq, Dk = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qr = q.reshape(B, Hkv, G, Dk)
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache).float()
    s = _softcap(s * scale, softcap)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype),
                       v_cache).float()
    return out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


def decode_attention_at_positions(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    slot_positions: torch.Tensor,
    cur_index: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a ring-buffer cache whose slot ``s`` holds the
    token at absolute position ``slot_positions[s]`` (< 0 ⇒ empty)."""
    valid = (slot_positions >= 0) & (slot_positions <= cur_index)
    if window is not None:
        valid &= slot_positions > cur_index - window
    return _decode_softmax_pv(q, k_cache, v_cache, valid, softcap=softcap,
                              scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_index: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a linear cache.  q: [B, 1, Hq, Dk];
    caches: [B, S, Hkv, D*]; ``cur_index``: the position of the current
    token (entries at s > cur_index are masked)."""
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos <= cur_index
    if window is not None:
        valid &= pos > cur_index - window
    return _decode_softmax_pv(q, k_cache, v_cache, valid, softcap=softcap,
                              scale=scale)


def ring_slot_positions(cur_index: int, size: int, device) -> torch.Tensor:
    """Absolute position each slot of a ring buffer of ``size`` holds when
    the token at ``cur_index`` has just been written: slot s holds
    cur − ((cur − s) mod size)."""
    slots = torch.arange(size, device=device)
    return cur_index - torch.remainder(cur_index - slots + size * 8, size)


# ---------------------------------------------------------------------------
# GQA attention sub-block (full / local), with KV cache plumbing
# ---------------------------------------------------------------------------


def attn_schema(cfg: ModelConfig, a: Optional[AttentionConfig] = None) -> Dict:
    a = a or cfg.attention
    D = cfg.d_model
    return {
        "wq": ParamSpec((D, a.num_heads, a.head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, a.num_kv_heads, a.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, a.num_kv_heads, a.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((a.num_heads, a.head_dim, D), ("heads", "head_dim", "embed")),
    }


def attn_cache_schema(cfg: ModelConfig, batch: int, seq: int,
                      a: Optional[AttentionConfig] = None,
                      local: bool = False) -> Dict:
    """KV cache buffers.  Local (sliding-window) layers allocate a
    ring buffer of ``window`` slots instead of the full sequence."""
    a = a or cfg.attention
    if local and a.window:
        seq = min(seq, a.window)
    shp = (batch, seq, a.num_kv_heads, a.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec(shp, axes, init="zeros"),
        "v": ParamSpec(shp, axes, init="zeros"),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum "bsd,dhk->bshk" as one GEMM."""
    d, h, k = w.shape
    y = x @ reshape(w.to(x.dtype), (d, h * k))
    return reshape(y, (*y.shape[:-1], h, k))


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum "bshk,hkd->bsd" as one GEMM."""
    h, k, d = w.shape
    return reshape(o, (*o.shape[:-2], h * k)) @ reshape(w.to(o.dtype),
                                                         (h * k, d))


def store_prefill(buf: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Persist a prefill's [B, S_in, ...] keys or values into a cache
    buffer [B, S_c, ...] at slot 0 on; a ring buffer smaller than the
    prompt keeps the trailing window, rotated so slot s holds position
    p with p % S_c == s."""
    S_c, S_in = buf.shape[1], val.shape[1]
    if S_in <= S_c:
        buf[:, :S_in] = val
    else:
        buf.copy_(_roll_seq(val[:, -S_c:], shift=S_in % S_c))
    return buf


@local_blocks([0, 0], [2, 2])
def _roll_seq(t: torch.Tensor, *, shift: int) -> torch.Tensor:
    """``t`` [B, S, H, ...] rolled along S (rows and heads apart)."""
    return torch.roll(t, shift, dims=1)


def apply_attn(
    p: Dict,
    x: torch.Tensor,
    ctx: Ctx,
    cache: Optional[Dict] = None,
    *,
    window: Optional[int] = None,
    a: Optional[AttentionConfig] = None,
    kv_x: Optional[torch.Tensor] = None,
    causal: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention sub-block (no norm / residual).  Returns (out, new_cache).

    ``kv_x`` switches to cross-attention (keys/values from the encoder);
    cross K/V are computed during prefill and then read from the cache.
    """
    cfg = ctx.cfg
    a = a or cfg.attention
    causal = a.causal if causal is None else causal

    q = _proj(x, p["wq"])
    q = shard_act(q, "batch", "seq", "act_heads", None)
    if a.use_rope:
        q = apply_rope(q, ctx.positions, a.rope_theta)

    if ctx.mode == "decode" and kv_x is None:
        k_new = _proj(x, p["wk"])
        v_new = _proj(x, p["wv"])
        if a.use_rope:
            k_new = apply_rope(k_new, ctx.positions, a.rope_theta)
        cur = int(ctx.cur_index)
        k_cache, v_cache = cache["k"], cache["v"]
        S_c = k_cache.shape[1]
        ring = window is not None and S_c == min(window, S_c)  # ring buffer
        # the reference's dynamic_update_slice clamps the offset
        write_at = min(cur % S_c if ring else cur, S_c - 1)
        k_cache[:, write_at] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, write_at] = v_new[:, 0].to(v_cache.dtype)
        if ring:
            out = decode_attention_at_positions(
                q, k_cache, v_cache, ring_slot_positions(cur, S_c, x.device),
                cur, window=window, softcap=a.logit_softcap)
        else:
            out = decode_attention(q, k_cache, v_cache, cur, window=window,
                                   softcap=a.logit_softcap)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        src = kv_x if kv_x is not None else x
        k = _proj(src, p["wk"])
        v = _proj(src, p["wv"])
        if a.use_rope and kv_x is None:
            k = apply_rope(k, ctx.positions, a.rope_theta)
        out = blockwise_attention(
            q, k, v, causal=causal and kv_x is None, window=window,
            softcap=a.logit_softcap, q_chunk=ctx.q_chunk,
            kv_chunk=ctx.kv_chunk, impl=ctx.attn_impl).to(x.dtype)
        new_cache = None
        if cache is not None:  # prefill: persist K/V into the cache buffers
            new_cache = {"k": store_prefill(cache["k"], k),
                         "v": store_prefill(cache["v"], v)}
    y = _out_proj(out, p["wo"])
    return shard_act(y, "batch", "seq", "act_embed"), new_cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_schema(cfg: ModelConfig) -> Dict:
    a = cfg.attention
    D, H = cfg.d_model, a.num_heads
    r_kv, r_q = a.kv_lora_rank, a.q_lora_rank
    dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    return {
        "wq_a": ParamSpec((D, r_q), ("embed", "lora")),
        "q_norm": ParamSpec((r_q,), ("norm",), init="ones"),
        "wq_b": ParamSpec((r_q, H, dn + dr), ("lora", "heads", "qk_dim")),
        "wkv_a": ParamSpec((D, r_kv), ("embed", "lora")),
        "kv_norm": ParamSpec((r_kv,), ("norm",), init="ones"),
        "wk_rope": ParamSpec((D, dr), ("embed", "qk_dim")),
        "wk_b": ParamSpec((r_kv, H, dn), ("lora", "heads", "qk_dim")),
        "wv_b": ParamSpec((r_kv, H, dv), ("lora", "heads", "head_dim")),
        "wo": ParamSpec((H, dv, D), ("heads", "head_dim", "embed")),
    }


def mla_cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    a = cfg.attention
    return {
        "ckv": ParamSpec((batch, seq, a.kv_lora_rank), ("batch", "kv_seq", "lora"),
                         init="zeros"),
        "krope": ParamSpec((batch, seq, a.qk_rope_head_dim),
                           ("batch", "kv_seq", "qk_dim"), init="zeros"),
    }


def apply_mla(
    p: Dict, x: torch.Tensor, ctx: Ctx, cache: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict]]:
    cfg = ctx.cfg
    a = cfg.attention
    B, S, D = x.shape
    H = a.num_heads
    dn, dr = a.qk_nope_head_dim, a.qk_rope_head_dim
    dt = x.dtype

    # --- queries (low-rank) ---------------------------------------------
    cq = rmsnorm_simple(x @ p["wq_a"].to(dt), p["q_norm"])
    qs = _proj(cq, p["wq_b"])
    q_nope, q_rope = qs[..., :dn], qs[..., dn:]
    q_rope = apply_rope(q_rope, ctx.positions, a.rope_theta)

    # --- compressed KV ----------------------------------------------------
    ckv_new = rmsnorm_simple(x @ p["wkv_a"].to(dt), p["kv_norm"])
    krope_new = apply_rope((x @ p["wk_rope"].to(dt))[:, :, None, :],
                           ctx.positions, a.rope_theta)[:, :, 0, :]

    scale = 1.0 / math.sqrt(dn + dr)

    if ctx.mode == "decode":
        cur = int(ctx.cur_index)
        ckv, krope = cache["ckv"], cache["krope"]
        at = min(cur, ckv.shape[1] - 1)
        ckv[:, at] = ckv_new[:, 0].to(ckv.dtype)
        krope[:, at] = krope_new[:, 0].to(krope.dtype)
        # Absorbed decode: fold W_uk into the query; attend in latent space.
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(dt))
        s = torch.einsum("bshr,btr->bhst", q_eff, ckv).float()
        s = s + torch.einsum("bshk,btk->bhst", q_rope, krope).float()
        pos = torch.arange(ckv.shape[1], device=x.device)
        s = torch.where((pos <= cur)[None, None, None], s * scale, NEG_INF)
        w = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", w.to(dt), ckv)
        out = torch.einsum("bshr,rhk->bshk", ctx_lat, p["wv_b"].to(dt))
        new_cache = {"ckv": ckv, "krope": krope}
    else:
        k_nope = _proj(ckv_new, p["wk_b"])
        v = _proj(ckv_new, p["wv_b"])
        k_rope_b = krope_new[:, :, None, :].expand(B, S, H, dr)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_b], dim=-1)
        out = blockwise_attention(
            q_full, k_full, v, causal=True, scale=scale,
            q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk, impl=ctx.attn_impl,
        ).to(dt)
        new_cache = None
        if cache is not None:
            ckv, krope = cache["ckv"], cache["krope"]
            ckv[:, :S] = ckv_new.to(ckv.dtype)
            krope[:, :S] = krope_new.to(krope.dtype)
            new_cache = {"ckv": ckv, "krope": krope}
    y = _out_proj(out, p["wo"])
    return shard_act(y, "batch", "seq", "act_embed"), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation.endswith("_glu"):
        return {
            "w_gate": ParamSpec((D, F_), ("embed", "ff")),
            "w_up": ParamSpec((D, F_), ("embed", "ff")),
            "w_down": ParamSpec((F_, D), ("ff", "embed")),
        }
    return {
        "w_up": ParamSpec((D, F_), ("embed", "ff")),
        "w_down": ParamSpec((F_, D), ("ff", "embed")),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.startswith("silu"):
        return F.silu(x)
    if name.startswith("gelu"):
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def apply_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    up = shard_act(up, "batch", "seq", "act_ff")
    if cfg.activation.endswith("_glu"):
        h = _act(cfg.activation, x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = _act(cfg.activation, up)
    y = h @ p["w_down"].to(x.dtype)
    return shard_act(y, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# Standard transformer blocks (attn + MLP), local variant, cross-attn variant
# ---------------------------------------------------------------------------


def _maybe_post_norm(cfg: ModelConfig):
    return bool(dict(cfg.extra).get("post_norm", False))


def attn_mlp_schema(cfg: ModelConfig, *, local: bool = False,
                    cross: bool = False) -> Dict:
    sch = {
        "ln_attn": norm_schema(cfg),
        "attn": mla_schema(cfg) if cfg.attention.kind == "mla" else attn_schema(cfg),
        "ln_mlp": norm_schema(cfg),
        "mlp": mlp_schema(cfg),
    }
    if cross:
        sch["ln_cross"] = norm_schema(cfg)
        sch["cross"] = attn_schema(cfg)
    if _maybe_post_norm(cfg):
        sch["ln_attn_post"] = norm_schema(cfg)
        sch["ln_mlp_post"] = norm_schema(cfg)
    return sch


def attn_mlp_cache_schema(cfg: ModelConfig, batch: int, seq: int, *,
                          cross: bool = False, local: bool = False) -> Dict:
    if cfg.attention.kind == "mla":
        out = {"attn": mla_cache_schema(cfg, batch, seq)}
    else:
        out = {"attn": attn_cache_schema(cfg, batch, seq, local=local)}
    if cross:
        enc_len = cfg.encdec.encoder_positions if cfg.encdec else 0
        out["cross"] = attn_cache_schema(cfg, batch, enc_len)
    return out


def apply_attn_mlp(
    p: Dict,
    x: torch.Tensor,
    ctx: Ctx,
    cache: Optional[Dict] = None,
    *,
    local: bool = False,
    cross: bool = False,
    causal: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    cfg = ctx.cfg
    window = cfg.attention.window if local else None
    post = _maybe_post_norm(cfg)
    new_cache: Dict = {}

    h = apply_norm(p["ln_attn"], cfg, x)
    if cfg.attention.kind == "mla":
        y, c = apply_mla(p["attn"], h, ctx, cache.get("attn") if cache else None)
    else:
        y, c = apply_attn(
            p["attn"], h, ctx, cache.get("attn") if cache else None,
            window=window, causal=causal,
        )
    if c is not None:
        new_cache["attn"] = c
    if post:
        y = apply_norm(p["ln_attn_post"], cfg, y)
    x = x + y

    if cross:
        h = apply_norm(p["ln_cross"], cfg, x)
        if ctx.mode == "decode":
            # Cross K/V are static after prefill; read straight from cache.
            ccache = cache["cross"]
            q = _proj(h, p["cross"]["wq"])
            out = decode_attention(q, ccache["k"], ccache["v"],
                                   ccache["k"].shape[1] - 1)
            y = _out_proj(out, p["cross"]["wo"])
            new_cache["cross"] = ccache
        else:
            y, c = apply_attn(
                p["cross"], h, ctx, cache.get("cross") if cache else None,
                kv_x=ctx.enc_out, causal=False,
            )
            if c is not None:
                new_cache["cross"] = c
        x = x + y

    h = apply_norm(p["ln_mlp"], cfg, x)
    y = apply_mlp(p["mlp"], cfg, h)
    if post:
        y = apply_norm(p["ln_mlp_post"], cfg, y)
    x = x + y
    return x, (new_cache if cache is not None else None), {}
