"""Plain PyTorch versions of the ported kernels: the CPU path of each
wrapper and the oracle each CUDA kernel is held against on the card.
Counterparts of ``repro.kernels.ref``.

Like the reference they compute in float32 at least (bf16 inputs are
widened); float64 inputs stay float64, so the card's check can evaluate
the plain version on float64 copies of a kernel's inputs.  The SSD and
sLSTM oracles are sequential Python loops over time, as the reference's
``scan``s are.  Their backward versions (``ssd_bwd_ref``,
``slstm_cell_bwd_ref``) are the backward kernels' algorithms written
out, not autograd: the chunked SSD run backwards and the sLSTM's
reverse recurrence.
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


def ssd_bwd_ref(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                cm: torch.Tensor, dy: torch.Tensor, chunk: int, *,
                grad_lag: Optional[int] = 0):
    """The vjp of :func:`ssd_ref` for the output gradient ``dy``, chunk by
    chunk as ``csrc/mamba2_ssd_bwd.cu`` runs it (Dao & Gu 2024,
    arXiv:2405.21060, §6–7, backwards), ``chunk`` dividing S.  With la the
    chunk's cumsum of dt·A, w_j = exp(la_L − la_j) and E_ij = exp(la_i −
    la_j) for j <= i (selected, never a mask times an overflow):
    (1) each chunk's entry state S_c; (2) each chunk's own state gradient
    Σ_i exp(la_i)·dy_i ⊗ C_i; (3) the reverse pass G_c = local_c +
    exp(la_L)·G_{c+1}; (4) per chunk, from M = (C·Bᵀ)∘E and Q = (dy·xᵀ)∘E,
    dx = Mᵀ·dy + w∘(B·G_{c+1}ᵀ), dB = Qᵀ·C + w∘(x·G_{c+1}), dC = Q·B +
    exp(la)∘(dy·S_c) and d la from its four terms; (5) d(dt·A) = d la's
    reverse cumsum within the chunk.  Returns (dxdt, dda, dB, dC) in the
    operands' dtypes.  ``grad_lag`` is for the plain variants a check
    must reject: 1 gives chunk c the state gradient one chunk late (G_c,
    stored after the reverse pass's update), None drops it (G = 0)."""
    b, s, h, p = xdt.shape
    n, nc, el = bm.shape[-1], s // chunk, chunk
    x = _wide(xdt).reshape(b, nc, el, h, p)
    a = _wide(da).reshape(b, nc, el, h)
    bw = _wide(bm).reshape(b, nc, el, h, n)
    cw = _wide(cm).reshape(b, nc, el, h, n)
    g = _wide(dy).reshape(b, nc, el, h, p)
    la = a.cumsum(2)
    la_last = la[:, :, -1]                          # [b, nc, h]
    w = torch.exp(la_last[:, :, None] - la)         # [b, nc, el, h]
    decay = torch.exp(la_last)[..., None, None]
    # (1) the state before each chunk
    own = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w, x, bw)
    run, states = x.new_zeros((b, h, p, n)), []
    for c in range(nc):
        states.append(run)
        run = run * decay[:, c] + own[:, c]
    st = torch.stack(states, 1)
    # (2), (3) the gradient of the state after each chunk
    local = torch.einsum("bcih,bcihp,bcihn->bchpn", torch.exp(la), g, cw)
    run, grads = torch.zeros_like(run), [None] * nc
    for c in reversed(range(nc)):
        grads[c] = run
        run = local[:, c] + decay[:, c] * run
        if grad_lag == 1:
            grads[c] = run
    gn = torch.stack(grads, 1)
    if grad_lag is None:
        gn = torch.zeros_like(gn)
    # (4) per chunk
    keep = torch.tril(torch.ones(el, el, dtype=torch.bool,
                                 device=xdt.device))[None, None, :, :, None]
    diff = la[:, :, :, None] - la[:, :, None]       # [b, nc, i, j, h]
    e = torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)
    dxm = torch.einsum("bcihp,bcjhp->bcijh", g, x)
    mm = torch.einsum("bcihn,bcjhn->bcijh", cw, bw) * e
    qq = dxm * e
    xg = torch.einsum("bcjhp,bchpn->bcjhn", x, gn)
    inter = torch.exp(la)[..., None] * torch.einsum("bcihp,bchpn->bcihn",
                                                    g, st)
    dx = (torch.einsum("bcijh,bcihp->bcjhp", mm, g)
          + w[..., None] * torch.einsum("bcjhn,bchpn->bcjhp", bw, gn))
    dbm = torch.einsum("bcijh,bcihn->bcjhn", qq, cw) + w[..., None] * xg
    dcm = torch.einsum("bcijh,bcjhn->bcihn", qq, bw) + inter
    # d la: the pairs (+ rows, − columns), the inter term, the chunk's
    # contribution to the next state, the carried state's decay
    pairs = mm * dxm
    u = w * (xg * bw).sum(-1)
    dla = pairs.sum(3) - pairs.sum(2) + (cw * inter).sum(-1) - u
    dla[:, :, -1] += u.sum(2) + torch.exp(la_last) * (st * gn).sum((-2, -1))
    # (5)
    dda = dla.flip(2).cumsum(2).flip(2)
    return (dx.reshape(b, s, h, p).to(xdt.dtype),
            dda.reshape(b, s, h).to(da.dtype),
            dbm.reshape(b, s, h, n).to(bm.dtype),
            dcm.reshape(b, s, h, n).to(cm.dtype))


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


def _slstm_steps(g_in: torch.Tensor, r_gates: torch.Tensor,
                 b_gates: torch.Tensor):
    """The sequential sLSTM, one step at a time: yields each step's gate
    pre-activations gg [B, 4, H, dh] and (h, c, n, m) after it, in float32
    at least."""
    g_all, r, bias = _wide(g_in), _wide(r_gates), _wide(b_gates)
    c = n = m = hid = g_all.new_zeros((g_in.shape[0], *g_in.shape[3:]))
    for t in range(g_in.shape[1]):
        gg = g_all[:, t] + torch.einsum("bhd,hdge->bghe", hid, r) + bias
        hid, c, n, m = slstm_gate(gg, c, n, m)
        yield gg, hid, c, n, m


def slstm_cell_state_ref(g_in: torch.Tensor, r_gates: torch.Tensor,
                         b_gates: torch.Tensor):
    """Sequential sLSTM with stabilized exponential gating.  g_in:
    [B, S, 4, H, dh]; r_gates: [H, dh, 4, dh]; b_gates: [4, H, dh] →
    (h [B, S, H, dh], (c, n, m) after the last step, each [B, H, dh] in
    float32 at least)."""
    hs = []
    for _, hid, *cnm in _slstm_steps(g_in, r_gates, b_gates):
        hs.append(hid)
    return torch.stack(hs, dim=1).to(g_in.dtype), tuple(cnm)


def slstm_cell_ref(g_in: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor) -> torch.Tensor:
    """:func:`slstm_cell_state_ref`'s h alone."""
    return slstm_cell_state_ref(g_in, r_gates, b_gates)[0]


def slstm_cell_fwd_traj_ref(g_in: torch.Tensor, r_gates: torch.Tensor,
                            b_gates: torch.Tensor):
    """:func:`slstm_cell_ref` and, per step, what the backward reads: the
    trajectory [B, S, 7, H, dh] (float32 at least) of the gate
    pre-activations (i, f, z, o) and c, n, m after the step — the layout
    the forward kernel writes under autograd."""
    hs, traj = [], []
    for gg, hid, c, n, m in _slstm_steps(g_in, r_gates, b_gates):
        hs.append(hid)
        traj.append(torch.cat([gg, torch.stack((c, n, m), 1)], 1))
    return torch.stack(hs, dim=1).to(g_in.dtype), torch.stack(traj, dim=1)


def slstm_param_grads(h: torch.Tensor, dgg: torch.Tensor, dtype):
    """dR[h] = Σ_{b,t} h_{t−1} ⊗ dgg_t and db = Σ_{b,t} dgg_t from the
    hidden trajectory h [B, S, H, dh] (h_{−1} = 0) and the gate gradients
    dgg [B, S, 4, H, dh]: one product and one sum over B·S, in ``dtype``."""
    hp = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1).to(dgg.dtype)
    dr = torch.einsum("bshd,bsghe->hdge", hp, dgg)
    return dr.to(dtype), dgg.sum((0, 1)).to(dtype)


def slstm_param_partials_ref(h: torch.Tensor, dgg: torch.Tensor,
                             rows: int):
    """What the backward kernel's clusters of ``rows`` batch rows write:
    per cluster z, :func:`slstm_param_grads` over its rows [z·rows,
    (z+1)·rows) — dR's partials [Z, H, dh, 4, dh] and db's [Z, 4, H, dh],
    Z = ceil(B / rows), in dgg's dtype.  Their sums over Z are dR and
    db."""
    parts = [slstm_param_grads(h[z:z + rows], dgg[z:z + rows], dgg.dtype)
             for z in range(0, h.shape[0], rows)]
    return (torch.stack([dr for dr, _ in parts]),
            torch.stack([db for _, db in parts]))


def slstm_cell_bwd_ref(traj: torch.Tensor, h: torch.Tensor,
                       r_gates: torch.Tensor, dy: torch.Tensor, *,
                       recurrent: bool = True):
    """The vjp of :func:`slstm_cell_ref` for the output gradient ``dy``
    [B, S, H, dh], from the forward's trajectory (``traj``, as
    :func:`slstm_cell_fwd_traj_ref` gives it) and hidden trajectory ``h``:
    the reverse recurrence ``csrc/slstm_cell_bwd.cu`` runs, each op's
    derivative as the plain version's autograd takes it (``logsigmoid``;
    ``torch.maximum`` splitting at a tie; ``clamp_min(n, 1e-6)`` passing
    where n >= 1e-6), with dh_{t−1}[d] += Σ_{g,e} R[d, g, e]·dgg_t[g, e].
    Returns (dg_in, dr, db): dg_in = dgg, and :func:`slstm_param_grads`.
    ``recurrent=False`` drops the recurrent term, for the plain variant a
    check must reject."""
    tw, r, g_out = _wide(traj), _wide(r_gates), _wide(dy)
    gg, cs = tw[:, :, :4], tw[:, :, 4:]
    dgg = torch.empty_like(gg)
    zero = g_out.new_zeros(g_out[:, 0].shape)
    dc = dn = dm = drec = zero
    for t in reversed(range(tw.shape[1])):
        li, fr, z, o = gg[:, t].unbind(1)
        c_new, n_new, m_new = cs[:, t].unbind(1)
        c_prev, n_prev, m_prev = cs[:, t - 1].unbind(1) if t else (zero,) * 3
        lf = F.logsigmoid(fr)
        a_arg = lf + m_prev
        ip, fp = torch.exp(li - m_new), torch.exp(a_arg - m_new)
        tz, so = torch.tanh(z), torch.sigmoid(o)
        nf = torch.clamp_min(n_new, 1e-6)
        dht = g_out[:, t] + drec
        d_o = dht * c_new / nf * so * (1 - so)
        dcn = dc + dht * so / nf
        dnn = dn + torch.where(n_new >= 1e-6, -dht * so * c_new / nf ** 2,
                               0.0)
        dfp = dcn * c_prev + dnn * n_prev
        dip = dcn * tz + dnn
        dz = dcn * ip * (1 - tz * tz)
        dmn = dm - dip * ip - dfp * fp
        dmax = dmn * torch.where(a_arg > li, 1.0,
                                 torch.where(a_arg == li, 0.5, 0.0))
        dli = dip * ip + (dmn - dmax)
        da = dfp * fp + dmax
        dc, dn, dm = dcn * fp, dnn * fp, da
        dgg[:, t] = torch.stack((dli, da * torch.sigmoid(-fr), dz, d_o), 1)
        if recurrent:
            drec = torch.einsum("hdge,bghe->bhd", r, dgg[:, t])
    return (dgg.to(dy.dtype),
            *slstm_param_grads(h, dgg, r_gates.dtype))
