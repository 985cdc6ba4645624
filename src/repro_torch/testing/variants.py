"""The model-layer kernels' check cases, and plain versions that each
differ from a kernel in one point.

A check of a kernel against its plain version can only catch what its
inputs make visible.  Each function here is the plain version with one
point of the kernel's semantics dropped (the softcap, the window, the
GQA head map, the last kv tile, the carried SSD state, the sLSTM
recurrence); a check that such a variant also passes is blind to that
point.  ``chip_smoke.py`` and the card tests hold each variant to
failing the check wherever it computes something different.

The case lists are ``tests/test_kernels.py``'s (attention options and
shapes ``(B, S, Hq, Hkv, D)``, SSD ``(B, S, H, P, N, chunk)``, sLSTM
``(B, S, H, dh)``), shared by ``chip_smoke.py`` and the port's tests.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import attention_ref, slstm_cell_ref, ssd_ref

ATTN_KW = [dict(causal=True), dict(causal=False),
           dict(causal=True, window=64), dict(causal=True, softcap=30.0),
           dict(causal=True, window=32, softcap=50.0)]
ATTN_SHAPES = [(2, 256, 8, 2, 64),     # GQA 4:1
               (1, 128, 4, 4, 128),    # MHA
               (2, 512, 8, 1, 64)]     # MQA
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64),
              (2, 64, 8, 16, 32, 16)]
SLSTM_SHAPES = [(2, 24, 4, 16), (1, 48, 2, 32)]


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
