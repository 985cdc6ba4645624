"""Plain PyTorch versions of the ported kernels: the CPU path of each
wrapper and the oracle each CUDA kernel is held against on the card.
Counterparts of ``repro.kernels.ref``.

Like the reference they compute in float32 at least (bf16 inputs are
widened); float64 inputs stay float64, so the card's check can evaluate
the plain version on float64 copies of a kernel's inputs.  The SSD and
sLSTM oracles are sequential Python loops over time, as the reference's
``scan``s are.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_wide(a) @ _wide(b)).to(a.dtype)


def stencil5_ref(u: torch.Tensor) -> torch.Tensor:
    up = F.pad(_wide(u), (1, 1, 1, 1))
    out = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
           - 4.0 * up[1:-1, 1:-1])
    return out.to(u.dtype)


def dg_diff_ref(diff_mat: torch.Tensor, ut: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mij,jk->mik", _wide(diff_mat),
                        _wide(ut)).to(ut.dtype)


def stream_ref(arrays: Sequence[torch.Tensor], *, block: int,
               stride: int) -> torch.Tensor:
    """Sum of the inputs' blocks ``i·stride`` into output block ``i``."""
    (s,) = arrays[0].shape
    n_out = s // (block * stride)
    acc = torch.zeros(n_out * block, dtype=_wide(arrays[0]).dtype,
                      device=arrays[0].device)
    for a in arrays:
        blocks = a.reshape(-1, block)[::stride][:n_out]
        acc = acc + _wide(blocks).reshape(-1)
    return acc.to(arrays[0].dtype)


def madd_ref(x: torch.Tensor, *, iters: int, a: float = 1.000001,
             b: float = 1e-7) -> torch.Tensor:
    """8 independent ``x·a + b`` chains, ``iters`` deep, summed in order.
    ``a`` and ``b`` are rounded to float32 first, as the kernel takes
    them, so a float64 evaluation differs from the kernel only by the
    kernel's own rounding."""
    w = _wide(x)
    a_t = torch.tensor(a, dtype=torch.float32).to(w.dtype)
    b_t = torch.tensor(b, dtype=torch.float32).to(w.dtype)
    xs = [w + i for i in range(8)]
    for _ in range(iters):
        xs = [xi * a_t + b_t for xi in xs]
    out = xs[0]
    for xi in xs[1:]:
        out = out + xi
    return out.to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialization softmax attention with GQA (query head h
    reads kv head h // G).  q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D*]
    → [B, Sq, Hq, Dv]."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = _wide(q).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, _wide(k)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, _wide(v))
    return o.reshape(b, sq, hq, dv).to(q.dtype)


def attention_bwd_ref(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None):
    """The vjp of :func:`attention_ref`, written out: (dq, dk, dv) for the
    output gradient ``dout`` [B, Sq, Hq, Dv], each in its operand's dtype
    (dk and dv summed over the G query heads of a kv head)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = _wide(q).reshape(b, sq, hkv, g, d)
    kw, vw = _wide(k), _wide(v)
    do = _wide(dout).reshape(b, sq, hkv, g, dv)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, kw) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vw)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kw) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qr) * scale
    dvw = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dvw.to(v.dtype))


def plain_vjp(fn, inputs: Sequence[torch.Tensor],
              grad_out: torch.Tensor) -> tuple:
    """The vjp of the plain version ``fn`` at ``inputs`` for the output
    gradient ``grad_out``, by autograd through its loop (a zero gradient
    for an input the output does not depend on)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        grads = torch.autograd.grad(fn(*leaves), leaves, grad_out,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads))


def ssd_state_ref(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                  cm: torch.Tensor):
    """Sequential SSD recurrence s_t = exp(da_t)·s_{t-1} + B_t ⊗ x_t,
    y_t = C_t · s_t.  xdt: [B, S, H, P]; da: [B, S, H]; bm/cm:
    [B, S, H, N] → (y [B, S, H, P], the state after the last step
    [B, H, P, N] in float32 at least)."""
    bsz, steps, h, p = xdt.shape
    x, a, bw, cw = _wide(xdt), _wide(da), _wide(bm), _wide(cm)
    state = x.new_zeros((bsz, h, p, bm.shape[-1]))
    ys = []
    for t in range(steps):
        state = state * torch.exp(a[:, t])[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", bw[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", cw[:, t], state))
    return torch.stack(ys, dim=1).to(xdt.dtype), state


def ssd_ref(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
            cm: torch.Tensor) -> torch.Tensor:
    """:func:`ssd_state_ref`'s y alone."""
    return ssd_state_ref(xdt, da, bm, cm)[0]


def slstm_gate(gg: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor):
    """One step's stabilized exponential gating: gate pre-activations
    gg [B, 4, H, dh] (i, f, z, o) and the state (c, n, m) → (h, c, n, m)."""
    li, lf, z_raw, o_raw = gg.unbind(dim=1)
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + m, li)
    ip = torch.exp(li - m_new)
    fp = torch.exp(lf + m - m_new)
    c = fp * c + ip * torch.tanh(z_raw)
    n = fp * n + ip
    return torch.sigmoid(o_raw) * c / torch.clamp_min(n, 1e-6), c, n, m_new


def slstm_cell_state_ref(g_in: torch.Tensor, r_gates: torch.Tensor,
                         b_gates: torch.Tensor):
    """Sequential sLSTM with stabilized exponential gating.  g_in:
    [B, S, 4, H, dh]; r_gates: [H, dh, 4, dh]; b_gates: [4, H, dh] →
    (h [B, S, H, dh], (c, n, m) after the last step, each [B, H, dh] in
    float32 at least)."""
    bsz, steps, _, h, dh = g_in.shape
    g_all, r, bias = _wide(g_in), _wide(r_gates), _wide(b_gates)
    c = n = m = hid = g_all.new_zeros((bsz, h, dh))
    hs = []
    for t in range(steps):
        gg = g_all[:, t] + torch.einsum("bhd,hdge->bghe", hid, r) + bias
        hid, c, n, m = slstm_gate(gg, c, n, m)
        hs.append(hid)
    return torch.stack(hs, dim=1).to(g_in.dtype), (c, n, m)


def slstm_cell_ref(g_in: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor) -> torch.Tensor:
    """:func:`slstm_cell_state_ref`'s h alone."""
    return slstm_cell_state_ref(g_in, r_gates, b_gates)[0]
