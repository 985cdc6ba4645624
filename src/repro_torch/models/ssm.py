"""Mamba-2 (SSD — state space duality) block — the counterpart of
``repro.models.ssm``.

Train and prefill run the chunked SSD scan through
:func:`repro_torch.kernels.ops.mamba2_ssd` (no cache) or
:func:`~repro_torch.kernels.ops.mamba2_ssd_state` (a prefill, which
leaves the state after the last step in the cache): on the card the
three passes of ``csrc/mamba2_ssd.cu``, on the host the plain
recurrence.  The reference rounds ``x·dt`` to the activation dtype
before its scan; the port rounds the same way, then widens to the
kernel's float32, with B and C repeated to heads.

Decode is a single-step state update: ``s ← exp(dt·A)·s + dt·B⊗x``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.param import ParamSpec
from repro_torch.sharding import local_blocks, reshape, shard_act


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    return s, di, H, s.head_dim, s.d_state, s.ngroups


def mamba2_schema(cfg: ModelConfig) -> Dict:
    s, di, H, P, N, G = _dims(cfg)
    D = cfg.d_model
    return {
        "ln": layers.norm_schema(cfg),
        "w_z": ParamSpec((D, di), ("embed", "ssm_inner")),
        "w_x": ParamSpec((D, di), ("embed", "ssm_inner")),
        "w_B": ParamSpec((D, G * N), ("embed", None)),
        "w_C": ParamSpec((D, G * N), ("embed", None)),
        "w_dt": ParamSpec((D, H), ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "conv_x": ParamSpec((s.d_conv, di), ("conv_kernel", "ssm_inner"),
                            init="small_normal"),
        "conv_B": ParamSpec((s.d_conv, G * N), ("conv_kernel", None),
                            init="small_normal"),
        "conv_C": ParamSpec((s.d_conv, G * N), ("conv_kernel", None),
                            init="small_normal"),
        "out_norm": ParamSpec((di,), ("norm",), init="ones"),
        "w_out": ParamSpec((di, D), ("ssm_inner", "embed")),
    }


def mamba2_cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    s, di, H, P, N, G = _dims(cfg)
    return {
        # last (d_conv - 1) pre-conv inputs for x, B, C
        "conv": ParamSpec((batch, s.d_conv - 1, di + 2 * G * N),
                          ("batch", None, "ssm_inner"), init="zeros"),
        "state": ParamSpec((batch, H, P, N),
                           ("batch", "ssm_heads", None, None), init="zeros"),
    }


@local_blocks([0, 0, "R"], [2, 2, 1])
def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  x: [B,S,C], w: [K,C]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):  # K is 4: unrolled taps, as the reference
        out = out + pad[:, i: i + S].float() * w[K - 1 - i]
    return out.to(x.dtype)


@local_blocks([0, 0, "R"], [2, 2, 1])
def conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One decode step of :func:`causal_conv`: window [B, K, C], oldest
    first, so the newest entry meets w[0] → [B, 1, C]."""
    return (window * w.flip(0)[None]).sum(1, keepdim=True)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero steps appended along dim 1."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)


@local_blocks([0] * 7, [1] * 7)
def _ssd_step(state: torch.Tensor, dA: torch.Tensor, Bdt: torch.Tensor,
              x: torch.Tensor, C: torch.Tensor):
    """One decode step of the SSD recurrence, rows and heads apart: state
    [B, H, P, N] decayed by dA [B, H] plus x [B, H, P] ⊗ Bdt [B, H, N];
    y [B, H, P] = C [B, H, N] · state.  (DTensor's einsum rule enumerates
    every placement over the mesh, minutes a step on 2 × 16 × 16.)"""
    state = state * dA[:, :, None, None] + torch.einsum("bhn,bhp->bhpn",
                                                        Bdt, x)
    return torch.einsum("bhn,bhpn->bhp", C, state), state


def apply_mamba2(
    p: Dict, x: torch.Tensor, ctx: layers.Ctx, cache: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    cfg = ctx.cfg
    s, di, H, P, N, G = _dims(cfg)
    B_, S, D = x.shape

    res = x
    h = layers.apply_norm(p["ln"], cfg, x)
    dt_ = h.dtype

    z = h @ p["w_z"].to(dt_)
    xin = h @ p["w_x"].to(dt_)
    Bin = h @ p["w_B"].to(dt_)
    Cin = h @ p["w_C"].to(dt_)
    dt_raw = h @ p["w_dt"].to(dt_)
    xin = shard_act(xin, "batch", "seq", "ssm_inner")
    z = shard_act(z, "batch", "seq", "ssm_inner")

    xbc = torch.cat([xin, Bin, Cin], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                       dim=-1).to(dt_)
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # [B,S,H]

    new_cache: Optional[Dict] = None
    if ctx.mode == "decode":
        # single step over the cached pre-conv window (oldest first, so
        # the newest entry meets conv_w[0]: flip the taps)
        window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                           dim=1)                      # [B, K, C]
        conv_out = conv_step(window, conv_w)
        conv_out = F.silu(conv_out.float()).to(dt_)
        xc, Bc, Cc = torch.split(conv_out, [di, G * N, G * N], dim=-1)
        xh = reshape(xc, (B_, 1, H, P))
        Bh = reshape(Bc, (B_, 1, G, N)).repeat_interleave(H // G, dim=2)
        Ch = reshape(Cc, (B_, 1, G, N)).repeat_interleave(H // G, dim=2)
        dA = torch.exp(dt * A)  # [B,1,H]
        y, state = _ssd_step(cache["state"], dA[:, 0],
                             Bh[:, 0] * dt[:, 0, :, None], xh[:, 0].float(),
                             Ch[:, 0].float())
        y = y[:, None] + xh.float() * p["D"].float()[None, None, :, None]
        y = reshape(y, (B_, 1, di)).to(dt_)
        new_cache = {"conv": window[:, 1:], "state": state}
    else:
        conv_out = F.silu(causal_conv(xbc, conv_w).float()).to(dt_)
        xc, Bc, Cc = torch.split(conv_out, [di, G * N, G * N], dim=-1)
        xh = reshape(xc, (B_, S, H, P))
        xdt = xh.float() * dt[..., None]
        dA = dt * A  # [B,S,H] (log-decay per step)
        # pad ragged lengths to a chunk multiple: dA = 0 (no decay) and
        # xdt = 0 (no input) make padded steps exact no-ops for the state
        chunk = min(s.chunk_size, S)
        pad = -(-S // chunk) * chunk - S
        # the reference's scan takes x·dt in the activation dtype
        xdt_p = _pad_seq(xdt, pad).to(dt_).float().contiguous()
        dA_p = _pad_seq(dA, pad).contiguous()
        Bh = _pad_seq(reshape(Bc, (B_, S, G, N)), pad).repeat_interleave(
            H // G, dim=2).float().contiguous()
        Ch = _pad_seq(reshape(Cc, (B_, S, G, N)), pad).repeat_interleave(
            H // G, dim=2).float().contiguous()
        if cache is not None:
            y, final_state = ops.mamba2_ssd_state(xdt_p, dA_p, Bh, Ch,
                                                  chunk=chunk)
        else:
            y = ops.mamba2_ssd(xdt_p, dA_p, Bh, Ch, chunk=chunk)
        y = y.to(dt_)[:, :S].float() \
            + xh.float() * p["D"].float()[None, None, :, None]
        y = reshape(y, (B_, S, di)).to(dt_)
        if cache is not None:  # prefill: stash conv window + final state
            tail = xbc[:, -(s.d_conv - 1):, :]
            new_cache = {"conv": tail.to(cache["conv"].dtype),
                         "state": final_state}

    y = layers.rmsnorm_simple(y * F.silu(z.float()).to(y.dtype),
                              p["out_norm"])
    out = y @ p["w_out"].to(dt_)
    out = shard_act(out, "batch", "seq", "act_embed")
    return res + out, new_cache, {}
