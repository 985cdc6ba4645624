"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM
(scalar) — the counterpart of ``repro.models.xlstm``.

mLSTM — a gated linear-attention recurrence with exponential input gates
and sigmoid forget gates, stabilized by a running max ``m``:

    C_t = f_t C_{t-1} + i_t v_t k_t^T      (matrix memory  [dh × dh])
    n_t = f_t n_{t-1} + i_t k_t            (normalizer      [dh])
    h_t = (C_t q_t) / max(|n_t · q_t|, exp(-m_t))

in plain torch, chunkwise exactly as the reference (chunked and recurrent
forms differ by up to 5e-2 of the logits).  sLSTM is a sequential
per-cell recurrence with block-diagonal (per-head) recurrent weights:
train and prefill run :func:`repro_torch.kernels.ops.slstm_cell` (no
cache) or :func:`~repro_torch.kernels.ops.slstm_cell_state` (a prefill)
on float32 gate inputs — on the card ``csrc/slstm_cell.cu``, on the host
the plain loop; decode is one plain step.  The kernel keeps h in float32
between steps, where the reference's scan rounds it to the activation
dtype each step: identical at float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import slstm_gate
from repro_torch.models import layers
from repro_torch.models.param import ParamSpec
from repro_torch.models.ssm import causal_conv, conv_step
from repro_torch.sharding import (elementwise, local_blocks, reshape,
                                  shard_act)


def _mdims(cfg: ModelConfig):
    x = cfg.xlstm
    M = int(x.m_proj_factor * cfg.d_model)
    H = x.num_heads
    dh = M // H
    return x, M, H, dh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


_logsigmoid = elementwise(F.logsigmoid)


def mlstm_schema(cfg: ModelConfig) -> Dict:
    x, M, H, dh = _mdims(cfg)
    D = cfg.d_model
    return {
        "ln": layers.norm_schema(cfg),
        "w_up": ParamSpec((D, M), ("embed", "ff")),
        "w_gate": ParamSpec((D, M), ("embed", "ff")),
        "conv": ParamSpec((x.s_conv_kernel, M), ("conv_kernel", "ff"),
                          init="small_normal"),
        "w_q": ParamSpec((M, M), ("ff", None)),
        "w_k": ParamSpec((M, M), ("ff", None)),
        "w_v": ParamSpec((M, M), ("ff", None)),
        "w_i": ParamSpec((M, H), ("ff", None), init="small_normal"),
        "b_i": ParamSpec((H,), (None,), init="zeros"),
        "w_f": ParamSpec((M, H), ("ff", None), init="small_normal"),
        "b_f": ParamSpec((H,), (None,), init="ones"),
        "out_norm": ParamSpec((M,), ("norm",), init="ones"),
        "w_down": ParamSpec((M, D), ("ff", "embed")),
    }


def mlstm_cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    x, M, H, dh = _mdims(cfg)
    return {
        "conv": ParamSpec((batch, x.s_conv_kernel - 1, M), ("batch", None, "ff"),
                          init="zeros"),
        "C": ParamSpec((batch, H, dh, dh), ("batch", "heads", None, None),
                       init="zeros"),
        "n": ParamSpec((batch, H, dh), ("batch", "heads", None), init="zeros"),
        "m": ParamSpec((batch, H), ("batch", "heads"), init="zeros"),
    }


@local_blocks([0, 0, 0, 0] + [0] * 5, [2, 1, 1, 1] + [2] * 5)
def _mlstm_chunked(q, k, v, li, lf, *, chunk: int):
    """Chunkwise stabilized mLSTM scan.

    q/k/v: [B,S,H,dh]; li (log input gate): [B,S,H]; lf (log forget):
    [B,S,H].  Returns h: [B,S,H,dh] and final (C, n, m).
    """
    B, S, H, dh = q.shape
    assert S % chunk == 0
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))[None, :, :, None]
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.zeros((B, H), dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, lic, lfc = q[:, sl], k[:, sl], v[:, sl], li[:, sl], \
            lf[:, sl]
        clf = torch.cumsum(lfc, dim=1)       # [B,l,H] cum log-forget
        # stabilizer per step: max(inter, best intra candidate)
        bj = lic - clf
        intra_max = torch.cummax(bj, dim=1).values + clf
        m_t = torch.maximum(m[:, None] + clf, intra_max)     # [B,l,H]
        # --- intra-chunk (masked linear attention with decay) -----------
        wij = (clf[:, :, None] - clf[:, None, :, :] + lic[:, None]
               - m_t[:, :, None])                            # [B,i,j,H]
        # mask inside the exp (the unselected branch may overflow)
        wij = torch.exp(torch.where(mask, wij, -1e9))
        s = torch.einsum("bihd,bjhd->bijh", qc, kc).float() * scale
        num_intra = torch.einsum("bijh,bjhd->bihd", s * wij, vc.float())
        den_intra = torch.einsum("bijh,bijh->bih", s, wij)
        # --- inter-chunk ---------------------------------------------------
        dec = torch.exp(m[:, None] + clf - m_t)              # [B,l,H]
        num_inter = torch.einsum("bihd,bhde->bihe", qc.float(),
                                 C) * scale * dec[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qc.float(),
                                 n) * scale * dec
        num = num_intra + num_inter
        den = den_intra + den_inter
        h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        # --- state update ----------------------------------------------
        m_new = torch.maximum(m + clf[:, -1], intra_max[:, -1])
        wL = torch.exp(clf[:, -1:] - clf + lic - m_new[:, None])  # [B,l,H]
        dC = torch.einsum("bjhd,bjhe->bhde", kc.float() * wL[..., None],
                          vc.float())
        dn = torch.einsum("bjhd,bjh->bhd", kc.float(), wL)
        decay = torch.exp(m + clf[:, -1] - m_new)[..., None]
        C = C * decay[..., None] + dC
        n = n * decay + dn
        m = m_new
        hs.append(h.to(q.dtype))
    return torch.cat(hs, dim=1), (C, n, m)


def apply_mlstm(
    p: Dict, x: torch.Tensor, ctx: layers.Ctx, cache: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    cfg = ctx.cfg
    xc, M, H, dh = _mdims(cfg)
    B, S, D = x.shape
    res = x
    h = layers.apply_norm(p["ln"], cfg, x)
    dt_ = h.dtype
    up = h @ p["w_up"].to(dt_)
    gate = h @ p["w_gate"].to(dt_)
    up = shard_act(up, "batch", "seq", "act_ff")

    new_cache: Optional[Dict] = None
    if ctx.mode == "decode":
        window = torch.cat([cache["conv"], up.to(cache["conv"].dtype)], 1)
        conv_w = p["conv"].to(dt_)
        # window is oldest-first; causal-conv tap k multiplies x[t-k]
        cx = conv_step(window, conv_w)
        cx = F.silu(cx.float()).to(dt_)
        q = reshape(cx @ p["w_q"].to(dt_), (B, H, dh))
        k = reshape(cx @ p["w_k"].to(dt_), (B, H, dh))
        v = reshape(up @ p["w_v"].to(dt_), (B, H, dh))
        li = reshape(cx @ p["w_i"].to(dt_), (B, H)).float() \
            + p["b_i"].float()
        lf = _logsigmoid(reshape(cx @ p["w_f"].to(dt_), (B, H)).float()
                          + p["b_f"].float())
        C, n, m = cache["C"], cache["n"], cache["m"]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        kf = k.float()
        C = C * fp[..., None, None] + ip[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kf, v.float())
        n = n * fp[..., None] + ip[..., None] * kf
        qf = q.float() / math.sqrt(dh)
        num = torch.einsum("bhd,bhde->bhe", qf, C)
        den = torch.einsum("bhd,bhd->bh", qf, n)
        hv = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        hv = reshape(hv, (B, 1, M)).to(dt_)
        new_cache = {"conv": window[:, 1:], "C": C, "n": n, "m": m_new}
    else:
        cx = F.silu(causal_conv(up, p["conv"].to(dt_)).float()).to(dt_)
        q = reshape(cx @ p["w_q"].to(dt_), (B, S, H, dh))
        k = reshape(cx @ p["w_k"].to(dt_), (B, S, H, dh))
        v = reshape(up @ p["w_v"].to(dt_), (B, S, H, dh))
        # the gates' sums over the (model-sharded) inner dim reduced here:
        # DTensor otherwise carries them partial into the scan, and its
        # backward into a layout its products cannot take
        li = shard_act((cx @ p["w_i"].to(dt_)).float() + p["b_i"].float(),
                       "batch", "seq", None)
        lf = shard_act(_logsigmoid((cx @ p["w_f"].to(dt_)).float()
                                   + p["b_f"].float()), "batch", "seq", None)
        # pad ragged lengths to a chunk multiple: li = -1e9 (no input
        # gate) and lf = 0 (no decay) make padded steps state no-ops
        chunk = min(xc.m_chunk_size, S)
        pad = -(-S // chunk) * chunk - S
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            li = F.pad(li, (0, 0, 0, pad), value=-1e9)
            lf = F.pad(lf, (0, 0, 0, pad))
        hv, (Cf, nf, mf) = _mlstm_chunked(q, k, v, li, lf, chunk=chunk)
        hv = reshape(hv[:, :S], (B, S, M))
        if cache is not None:
            tail = up[:, -(xc.s_conv_kernel - 1):, :]
            new_cache = {"conv": tail.to(cache["conv"].dtype),
                         "C": Cf, "n": nf, "m": mf}

    hv = layers.rmsnorm_simple(hv, p["out_norm"])
    hv = hv * F.silu(gate.float()).to(hv.dtype)
    out = hv @ p["w_down"].to(dt_)
    return res + shard_act(out, "batch", "seq", "act_embed"), new_cache, {}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _sdims(cfg: ModelConfig):
    x = cfg.xlstm
    H = x.num_heads
    dh = cfg.d_model // H
    F_ = int(x.s_proj_factor * cfg.d_model)
    return x, H, dh, F_


def slstm_schema(cfg: ModelConfig) -> Dict:
    x, H, dh, F_ = _sdims(cfg)
    D = cfg.d_model
    return {
        "ln": layers.norm_schema(cfg),
        # gates i, f, z, o — input + block-diagonal (per-head) recurrent
        "w_gates": ParamSpec((D, 4, H, dh), ("embed", None, "heads",
                                             "slstm_hidden")),
        "r_gates": ParamSpec((H, dh, 4, dh), ("heads", None, None,
                                              "slstm_hidden"),
                             init="small_normal"),
        "b_gates": ParamSpec((4, H, dh), (None, "heads", "slstm_hidden"),
                             init="zeros"),
        "out_norm": ParamSpec((D,), ("norm",), init="ones"),
        "ln_ff": ParamSpec((D,), ("norm",), init="ones"),
        # post-block gated FFN (proj factor 4/3)
        "w_ff_gate": ParamSpec((D, F_), ("embed", "ff")),
        "w_ff_up": ParamSpec((D, F_), ("embed", "ff")),
        "w_ff_down": ParamSpec((F_, D), ("ff", "embed")),
    }


def slstm_cache_schema(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    x, H, dh, F_ = _sdims(cfg)
    ax = ("batch", "heads", "slstm_hidden")
    return {
        "c": ParamSpec((batch, H, dh), ax, init="zeros"),
        "n": ParamSpec((batch, H, dh), ax, init="zeros"),
        "m": ParamSpec((batch, H, dh), ax, init="zeros"),
        "h": ParamSpec((batch, H, dh), ax, init="zeros"),
    }


def _slstm_step(p, state, g_in):
    """One sLSTM step, the reference's ``_slstm_cell``.  g_in: [B,4,H,dh]
    (input contribution to gates); state (c, n, m, h_prev)."""
    c, n, m, hprev = state
    rec = torch.einsum("bhd,hdge->bghe", hprev, p["r_gates"].to(hprev.dtype))
    g = g_in.float() + rec.float() + p["b_gates"].float()[None]
    h_new, c_new, n_new, m_new = slstm_gate(g, c, n, m)
    return (c_new, n_new, m_new, h_new.to(hprev.dtype)), h_new


def apply_slstm(
    p: Dict, x: torch.Tensor, ctx: layers.Ctx, cache: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    cfg = ctx.cfg
    xc, H, dh, F_ = _sdims(cfg)
    B, S, D = x.shape
    res = x
    h = layers.apply_norm(p["ln"], cfg, x)
    dt_ = h.dtype
    wg = p["w_gates"].to(dt_)
    g_in = reshape(h @ reshape(wg, (D, 4 * H * dh)), (B, S, 4, H, dh))

    if ctx.mode == "decode":
        state = (cache["c"], cache["n"], cache["m"], cache["h"].to(dt_))
        state, hv = _slstm_step(p, state, g_in[:, 0])
        hv = reshape(hv, (B, 1, D)).to(dt_)
        new_cache = {"c": state[0], "n": state[1], "m": state[2],
                     "h": state[3].to(cache["h"].dtype)}
    else:
        args = (g_in.float().contiguous(), p["r_gates"].float().contiguous(),
                p["b_gates"].float().contiguous())
        new_cache = None
        if cache is not None:
            hs, (c, n, m) = ops.slstm_cell_state(*args)
            new_cache = {"c": c, "n": n, "m": m,
                         "h": hs[:, -1].to(dt_).to(cache["h"].dtype)}
        else:
            hs = ops.slstm_cell(*args)
        hv = reshape(hs, (B, S, D)).to(dt_)

    hv = layers.rmsnorm_simple(hv, p["out_norm"])
    x = res + hv
    # post FFN (gated, 4/3 factor)
    h2 = layers.rmsnorm_simple(x, p["ln_ff"])
    up = h2 @ p["w_ff_up"].to(x.dtype)
    gate = F.gelu((h2 @ p["w_ff_gate"].to(x.dtype)).float(),
                  approximate="tanh").to(x.dtype)
    y = (gate * up) @ p["w_ff_down"].to(x.dtype)
    return x + shard_act(y, "batch", "seq", "act_embed"), new_cache, {}
