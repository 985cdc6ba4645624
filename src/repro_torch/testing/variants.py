"""The model-layer kernels' check cases, and plain versions that each
differ from a kernel in one point.

A check of a kernel against its plain version can only catch what its
inputs make visible.  Each function here is the plain version with one
point of the kernel's semantics dropped (the softcap, the window, the
GQA head map, the last kv tile, the carried SSD state, the sLSTM
recurrence) or with the fault its design invites (the SSD's state one
chunk late, the sLSTM's peers' h one step stale), and likewise for the
backward kernels (the SSD's carried state gradient dropped or one chunk
late, the sLSTM's recurrent dh term dropped); a check that such a
variant also passes is blind to that point.  ``chip_smoke.py`` and the
card tests hold each variant to failing the check wherever it computes
something different.

The case lists are ``tests/test_kernels.py``'s (attention options and
shapes ``(B, S, Hq, Hkv, D)``, SSD ``(B, S, H, P, N, chunk)``, sLSTM
``(B, S, H, dh)``), shared by ``chip_smoke.py`` and the port's tests.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import (_wide, attention_ref,
                                     slstm_cell_bwd_ref, slstm_cell_ref,
                                     slstm_gate, ssd_bwd_ref, ssd_ref)
from repro_torch.kernels.slstm_cell import cluster_blocks

ATTN_KW = [dict(causal=True), dict(causal=False),
           dict(causal=True, window=64), dict(causal=True, softcap=30.0),
           dict(causal=True, window=32, softcap=50.0)]
ATTN_SHAPES = [(2, 256, 8, 2, 64),     # GQA 4:1
               (1, 128, 4, 4, 128),    # MHA
               (2, 512, 8, 1, 64)]     # MQA
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64),
              (2, 64, 8, 16, 32, 16)]
SLSTM_SHAPES = [(2, 24, 4, 16), (1, 48, 2, 32),
                # the cluster split: 6 blocks of 9, 9, 9, 9, 9, 5 units,
                # and xlstm-125m's head width dh = 192 (6 × 32 units)
                (2, 24, 4, 50), (1, 16, 2, 192)]


def attention_without_softcap(q, k, v, **kw):
    return attention_ref(q, k, v, **{**kw, "softcap": None})


def attention_without_window(q, k, v, **kw):
    return attention_ref(q, k, v, **{**kw, "window": None})


def attention_kv_head_mod(q, k, v, **kw):
    """Query head h reads kv head ``h % Hkv`` instead of ``h // G``;
    the two maps agree for MHA and MQA."""
    idx = torch.arange(q.shape[2], device=q.device) % k.shape[2]
    return attention_ref(q, k[:, :, idx], v[:, :, idx], **kw)


def attention_skip_last_kv_tile(q, k, v, *, block_k, **kw):
    """The kv loop stops one tile short: the last ``block_k`` keys are
    never visited.  Only the last query rows see them (under a causal
    mask), so a check that passes this variant cannot see late rows."""
    keep = k.shape[1] - block_k
    if keep <= 0:
        raise ValueError(f"Skv = {k.shape[1]} has no kv tile before the "
                         f"last {block_k} keys")
    return attention_ref(q, k[:, :keep], v[:, :keep], **kw)


def attention_variants_for(kw, hq, hkv):
    """(label, fn) for each plain variant that differs from the kernel
    under options ``kw`` at head counts (hq, hkv), with ``kw`` bound."""
    wrongs = []
    if kw.get("softcap") is not None:
        wrongs.append(("no softcap", attention_without_softcap))
    if kw.get("window") is not None:
        wrongs.append(("no window", attention_without_window))
    if hkv not in (1, hq):
        wrongs.append(("kv head h % Hkv", attention_kv_head_mod))
    return [(label, functools.partial(fn, **kw)) for label, fn in wrongs]


def ssd_without_carried_state(xdt, da, bm, cm, *, chunk):
    """Each chunk starts from a zero state."""
    return torch.cat([ssd_ref(*(t[:, c:c + chunk] for t in (xdt, da, bm, cm)))
                      for c in range(0, xdt.shape[1], chunk)], dim=1)


def slstm_without_recurrence(g_in, r_gates, b_gates):
    """``r = 0``: the gates see only the input contributions."""
    return slstm_cell_ref(g_in, torch.zeros_like(r_gates), b_gates)


def ssd_chunked(xdt, da, bm, cm, *, chunk, lag=0):
    """The SSD by chunks, as the kernel's passes compute it: each chunk's
    output from its own tokens (zero initial state) plus exp(la)∘(C·Sᵀ),
    S the state from ``lag`` chunks before the one it should use (the
    state before the chunk); states before the first chunk are zero.
    ``lag=0`` is the SSD."""
    bsz, s, h, p = xdt.shape
    before = [xdt.new_zeros((bsz, h, p, bm.shape[-1]))] * (lag + 1)
    outs = []
    for c0 in range(0, s, chunk):
        x, a, b_, c_ = (t[:, c0:c0 + chunk] for t in (xdt, da, bm, cm))
        la = torch.cumsum(_wide(a), dim=1)                     # [B, L, H]
        outs.append(ssd_ref(x, a, b_, c_) + torch.exp(la)[..., None]
                    * torch.einsum("blhn,bhpn->blhp", c_, before[-1 - lag]))
        w = torch.exp(la[:, -1:] - la)
        before.append(before[-1] * torch.exp(la[:, -1])[..., None, None]
                      + torch.einsum("blh,blhp,blhn->bhpn", w, x, b_))
    return torch.cat(outs, dim=1)


def ssd_state_one_chunk_late(xdt, da, bm, cm, *, chunk):
    """Chunk c's inter-chunk term takes the state from before chunk c − 1:
    the off-by-one the state-passing pass invites."""
    return ssd_chunked(xdt, da, bm, cm, chunk=chunk, lag=1)


def slstm_split(g_in, r_gates, b_gates, *, peer_lag=0):
    """The sLSTM as the kernel's cluster splits it: block q of
    ``cluster_blocks(dh)`` owns ``ceil(dh / blocks)`` hidden units with
    their gate columns; its columns see its own units' h from step t − 1
    and its peers' from step t − 1 − ``peer_lag``.  ``peer_lag=0`` is the
    sLSTM."""
    bsz, steps, _, h, dh = g_in.shape
    g_all, r, bias = _wide(g_in), _wide(r_gates), _wide(b_gates)
    block = torch.arange(dh, device=r.device) // -(-dh // cluster_blocks(dh))
    own = (block[:, None] == block[None, :]).to(r.dtype)   # [d, unit]
    r_own, r_peer = r * own[:, None], r * (1 - own)[:, None]
    c = n = m = g_all.new_zeros((bsz, h, dh))
    hist = [c] * (peer_lag + 1)       # h of the last peer_lag + 1 steps
    hs = []
    for t in range(steps):
        gg = (g_all[:, t] + torch.einsum("bhd,hdge->bghe", hist[-1], r_own)
              + torch.einsum("bhd,hdge->bghe", hist[-1 - peer_lag], r_peer)
              + bias)
        hid, c, n, m = slstm_gate(gg, c, n, m)
        hist = hist[1:] + [hid]
        hs.append(hid)
    return torch.stack(hs, dim=1).to(g_in.dtype)


def slstm_peer_h_stale(g_in, r_gates, b_gates):
    """Each block's gate columns see their own units' h from step t − 1
    but the peers' from step t − 2: a missing or early cluster
    barrier."""
    return slstm_split(g_in, r_gates, b_gates, peer_lag=1)


# the backward kernels' plain variants (``chip_smoke.py`` phase 17 (a)):
# the SSD's gradient without the state gradient carried between chunks,
# or with it one chunk late; the sLSTM's without the recurrent dh term


def ssd_bwd_without_carried_gradient(xdt, da, bm, cm, dy, chunk):
    return ssd_bwd_ref(xdt, da, bm, cm, dy, chunk, grad_lag=None)


def ssd_bwd_gradient_one_chunk_late(xdt, da, bm, cm, dy, chunk):
    return ssd_bwd_ref(xdt, da, bm, cm, dy, chunk, grad_lag=1)


def slstm_bwd_without_recurrence(traj, h, r_gates, dy):
    return slstm_cell_bwd_ref(traj, h, r_gates, dy, recurrent=False)
