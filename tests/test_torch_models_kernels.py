"""The model-layer kernels in the port — flash attention, the Mamba-2 SSD
scan and the sLSTM cell — against the JAX package on the CPU.

* Each ``repro_torch.kernels.ops`` wrapper (its plain version: the
  tensors lie on the CPU) against ``repro.kernels.ops`` in Pallas
  interpret mode at every ``tests/test_kernels.py`` case and tolerance,
  on the same numpy inputs.
* The cost rules: attention against the closed forms of
  ``tests/test_pallascost.py`` (and a bf16 case); the arithmetic of all
  three against the reference counter (``repro.core.counting.count_fn``)
  run on ONE program's body — the Pallas kernel's body with its refs
  replaced by arrays — times the grid.  The reference's own Pallas
  costing does not run under the installed jax, whose nested ``jit``s
  the reference counter does not open (ROADMAP queue C), so the bodies
  are traced under ``jax.disable_jit()``, which inlines them; the
  ``fori_loop`` counter and index arithmetic that the port's rule leaves
  out are stated as ``COUNT_DIFFERENCES`` states them.  Traffic against
  the block-refetch closed form.
* ``predict --kernel`` prices the three from a host profile with zero
  timings; the port's copy of the configs equals the reference's.

The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.counting import count_fn as jcount_fn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch.analysis.kernelcost import BYTES_IN_FEATURE, BYTES_OUT_FEATURE
from repro_torch.analysis.targets import f32
from repro_torch.core.counting import count_fn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_cell as tsc
from repro_torch.testing import variants
from repro_torch.testing.variants import (ATTN_KW, ATTN_SHAPES, SLSTM_SHAPES,
                                          SSD_SHAPES)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NEG_INF = -1e30


def rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dt: str = "float32"):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(port: torch.Tensor, ref, dt: str = "float32"):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


# ---------------------------------------------------------------------------
# the wrappers' CPU paths against the reference in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
def test_flash_attention_matches_reference(dt, kw, B, S, Hq, Hkv, D):
    (jq, tq), (jk, tk), (jv, tv) = (_both(rn(3, B, S, Hq, D), dt),
                                    _both(rn(4, B, S, Hkv, D), dt),
                                    _both(rn(5, B, S, Hkv, D), dt))
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    got = tops.flash_attention(tq, tk, tv, block_q=64, block_k=64, **kw)
    assert got.dtype == tq.dtype and got.shape == (B, S, Hq, D)
    _close(got, want, dt)


def _ssd_inputs(B, S, H, P, N):
    return (rn(6, B, S, H, P), -np.abs(rn(7, B, S, H)) * 0.1,
            rn(8, B, S, H, N), rn(9, B, S, H, N))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_mamba2_ssd_matches_reference(B, S, H, P, N, chunk):
    pairs = [_both(x) for x in _ssd_inputs(B, S, H, P, N)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jops.mamba2_ssd(*js, chunk=chunk)
    _close(tops.mamba2_ssd(*ts, chunk=chunk), want)
    _close(tref.ssd_ref(*ts), jref.ssd_ref(*js))


def _slstm_inputs(B, S, H, dh):
    return (rn(50, B, S, 4, H, dh) * 0.5, rn(51, H, dh, 4, dh) * 0.1,
            rn(52, 4, H, dh) * 0.1)


@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES)
def test_slstm_cell_matches_reference(B, S, H, dh):
    pairs = [_both(x) for x in _slstm_inputs(B, S, H, dh)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jops.slstm_cell(*js)
    _close(tops.slstm_cell(*ts), want)
    _close(tref.slstm_cell_ref(*ts), jref.slstm_cell_ref(*js))


@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES[:2])
def test_slstm_cell_bf16_follows_the_pallas_kernel(B, S, H, dh, wdt):
    """For a bf16 ``g_in`` the port's CPU op keeps h in f32 between
    steps and rounds only its output, as the Pallas kernel does (h in f32
    scratch), not as ``repro.kernels.ref.slstm_cell_ref``, which rounds h
    to bf16 every step."""
    g, r, b = _slstm_inputs(B, S, H, dh)
    (jg, tg), (jr, tr), (jb, tb) = (_both(g, "bfloat16"), _both(r, wdt),
                                    _both(b, wdt))
    got = tops.slstm_cell(tg, tr, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, dh)
    _close(got, jops.slstm_cell(jg, jr, jb), "bfloat16")


def test_mamba2_ssd_kernel_chunk_divides_the_callers():
    """The CUDA kernel runs at its own chunk: the caller's largest divisor
    up to 64 tokens."""
    want = {16: 16, 32: 32, 50: 50, 64: 64, 96: 48, 100: 50, 128: 64,
            200: 50, 254: 2, 256: 64}
    assert {c: tssd.inner_chunk(c) for c in want} == want
    assert all(c % tssd.inner_chunk(c) == 0 for c in range(1, 257))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_state_one_chunk_late_is_visible(B, S, H, P, N, chunk):
    """The chunked form with each chunk's own state equals the JAX
    reference; taking the state one chunk late differs from it beyond the
    f32 tolerance, so a check at these cases rejects that fault."""
    pairs = [_both(x) for x in _ssd_inputs(B, S, H, P, N)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    want = np.asarray(jref.ssd_ref(*js))
    _close(variants.ssd_chunked(*ts, chunk=chunk), want)
    late = variants.ssd_state_one_chunk_late(*ts, chunk=chunk).numpy()
    assert not np.allclose(late, want, **TOL["float32"])


@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES)
def test_slstm_peer_h_stale_is_visible(B, S, H, dh):
    """The sLSTM as the kernel's cluster splits it equals the JAX
    reference; with the peers' h one step stale it differs beyond the f32
    tolerance, so a check at these cases rejects that fault."""
    pairs = [_both(x) for x in _slstm_inputs(B, S, H, dh)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    want = np.asarray(jref.slstm_cell_ref(*js))
    _close(variants.slstm_split(*ts), want)
    stale = variants.slstm_peer_h_stale(*ts).numpy()
    assert not np.allclose(stale, want, **TOL["float32"])


def test_skip_last_kv_tile_variant_changes_only_late_rows():
    """The variant a real-size attention check must reject: under a
    causal mask it agrees with the plain version on every query row
    before the last kv tile and differs after it."""
    q, k, v = (torch.from_numpy(rn(s, 1, 256, 4, 32)) for s in (60, 61, 62))
    want = tref.attention_ref(q, k, v, causal=True)
    got = variants.attention_skip_last_kv_tile(q, k, v, block_k=64,
                                               causal=True)
    torch.testing.assert_close(got[:, :192], want[:, :192])
    assert not torch.allclose(got[:, 192:], want[:, 192:], **TOL["float32"])
    with pytest.raises(ValueError, match="no kv tile"):
        variants.attention_skip_last_kv_tile(q, k[:, :64], v[:, :64],
                                             block_k=64)


def test_cpu_path_launches_nothing_and_wrappers_validate():
    before = (tfa.launches, tssd.launches, tsc.launches)
    tops.flash_attention(*[torch.ones(1, 64, 2, 16)] * 3, block_q=32,
                         block_k=16)
    tops.mamba2_ssd(torch.ones(1, 64, 2, 8), -torch.ones(1, 64, 2),
                    *[torch.ones(1, 64, 2, 4)] * 2, chunk=16)
    tops.slstm_cell(torch.ones(1, 4, 4, 2, 8), torch.zeros(2, 8, 4, 8),
                    torch.zeros(4, 2, 8))
    assert (tfa.launches, tssd.launches, tsc.launches) == before
    with pytest.raises(ValueError, match="do not tile"):
        tops.flash_attention(*[torch.ones(1, 96, 2, 16)] * 3, block_q=64)
    with pytest.raises(ValueError, match="do not tile"):
        tops.flash_attention(torch.ones(1, 64, 2, 16),
                             *[torch.ones(1, 96, 2, 16)] * 2, block_k=64)
    with pytest.raises(ValueError, match="does not tile"):
        tops.mamba2_ssd(torch.ones(1, 96, 2, 8), torch.ones(1, 96, 2),
                        *[torch.ones(1, 96, 2, 4)] * 2, chunk=64)
    with pytest.raises(ValueError, match=r"\[B, S, 4, H, dh\]"):
        tops.slstm_cell(torch.ones(1, 4, 3, 2, 8), torch.zeros(2, 8, 4, 8),
                        torch.zeros(4, 2, 8))
    # blocks clamp to the array, as in the reference
    out = tops.flash_attention(*[torch.ones(1, 32, 2, 16)] * 3)
    assert out.shape == (1, 32, 2, 16)


# ---------------------------------------------------------------------------
# cost rules
# ---------------------------------------------------------------------------


def _arith(counts):
    return {k: v for k, v in counts.items() if k.startswith("f_op_")}


def _diff(want, got):
    return {k: want[k] - got[k] for k in set(_arith(want)) | set(_arith(got))
            if want[k] != got[k]}


def _scaled(counts, mult):
    return {k: v * mult for k, v in counts.items()}


def _sum(*parts):
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0.0) + v
    return out


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", [
    (2, 256, 8, 2, 64, 64, 64),
    (1, 128, 4, 4, 64, 64, 64),
    (2, 512, 8, 2, 64, 128, 64),
])
def test_flash_attention_cost_rule_matches_closed_form(B, S, Hq, Hkv, D, bq,
                                                        bk):
    fn = functools.partial(tops.flash_attention, causal=True, block_q=bq,
                           block_k=bk)
    c = count_fn(fn, f32(B, S, Hq, D), f32(B, S, Hkv, D), f32(B, S, Hkv, D))
    nq, nk = S // bq, S // bk
    # tests/test_pallascost.py::test_flash_attention_counts_match_closed_form
    assert c["f_op_float32_madd"] == B * Hq * S * S * (D + D)
    q_bytes = 4 * B * Hq * nq * bq * D
    k_bytes = 4 * B * Hq * nq * nk * bk * D
    v_bytes = 4 * B * Hq * nq * nk * bk * D
    assert c[BYTES_IN_FEATURE] == q_bytes + k_bytes + v_bytes
    assert c[BYTES_OUT_FEATURE] == 4 * B * Hq * S * D
    assert c["f_op_float32_transc"] == B * Hq * nq * nk * (bq * bk + bq)
    assert c["f_sync_grid_programs"] == B * Hq * nq * nk


def test_flash_attention_cost_rule_bf16_traffic():
    B, S, Hq, Hkv, D, Dv, b = 1, 256, 4, 2, 64, 32, 64
    fn = functools.partial(tops.flash_attention, block_q=b, block_k=b,
                           softcap=50.0)
    bf16 = functools.partial(torch.empty, dtype=torch.bfloat16,
                             device="meta")
    c = count_fn(fn, bf16(B, S, Hq, D), bf16(B, S, Hkv, D),
                 bf16(B, S, Hkv, Dv))
    n = S // b
    loads = B * Hq * n * b * D + B * Hq * n * n * b * (D + Dv)
    assert c["f_mem_contig_bfloat16_load"] == loads
    assert c["f_mem_contig_bfloat16_store"] == B * Hq * S * Dv
    assert c[BYTES_IN_FEATURE] == 2 * loads
    assert c[BYTES_OUT_FEATURE] == 2 * B * Hq * S * Dv
    assert c["f_mem_contig_float32_load"] == 0
    # the arithmetic stays f32, as the reference counts dot_general by its
    # f32 output; softcap adds a tanh per score
    assert c["f_op_float32_madd"] == B * Hq * S * S * (D + Dv)
    assert c["f_op_float32_transc"] == B * Hq * n * n * (2 * b * b + b)
    # a single kv step: K and V fetched once per (batch, kv head)
    c1 = count_fn(functools.partial(tops.flash_attention, block_q=b,
                                    block_k=S),
                  bf16(B, S, Hq, D), bf16(B, S, Hkv, D), bf16(B, S, Hkv, Dv))
    assert c1[BYTES_IN_FEATURE] == 2 * (B * Hq * S * D
                                        + B * Hkv * S * (D + Dv))


def _tiles_with_unmasked_pairs(sq, skv, causal, window, tile_q):
    """(query tile, kv tile) pairs that hold at least one unmasked (q, k)
    pair, by brute force over the reference's mask."""
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    nq, nk = -(-sq // tile_q), -(-skv // tfa.TILE_K)
    padded = np.zeros((nq * tile_q, nk * tfa.TILE_K), bool)
    padded[:sq, :skv] = keep
    return int(padded.reshape(nq, tile_q, nk, tfa.TILE_K).any(
        axis=(1, 3)).sum())


@pytest.mark.parametrize("sq,skv,causal,window,tile_q", [
    (256, 256, True, None, 128), (256, 256, False, None, 64),
    (512, 512, True, 24, 128), (512, 512, True, 160, 64),
    (512, 512, False, 100, 128), (160, 96, True, 40, 64),
    (96, 160, True, 40, 128), (192, 192, True, 0, 128),
    (8192, 8192, True, 4096, 128), (8192, 8192, True, None, 128)])
def test_kernel_visits_exactly_the_kv_tiles_with_unmasked_pairs(
        sq, skv, causal, window, tile_q):
    """The kv range the kernel walks per query tile is exact: every tile
    outside it is fully masked (so skipping it changes nothing) and every
    tile inside holds an unmasked pair."""
    assert tfa.kv_tiles_visited(sq, skv, causal, window, tile_q) == \
        _tiles_with_unmasked_pairs(sq, skv, causal, window, tile_q)


def test_gemma_layers_visit_fewer_kv_tiles_than_a_full_sweep():
    full = 64 * 128   # 128-row query tiles × 64-row kv tiles at S = 8192
    assert tfa.kv_tiles_visited(8192, 8192, True, 4096, 128) == 3168
    assert tfa.kv_tiles_visited(8192, 8192, True, None, 128) == 4160
    assert tfa.kv_tiles_visited(8192, 8192, False, None, 128) == full


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,Dv,kw", [
    (2, 256, 256, 8, 2, 64, 64, dict(causal=True)),
    (1, 512, 512, 4, 2, 256, 256, dict(causal=True, window=160)),
    (1, 160, 96, 4, 2, 48, 33, dict(causal=True, window=40)),
    (1, 256, 256, 4, 2, 64, 32, dict(causal=False, softcap=50.0)),
    (1, 8192, 8192, 16, 8, 256, 256,
     dict(causal=True, window=4096, softcap=50.0)),
])
def test_flash_attention_staging_term_counts_visited_tiles(
        dt, B, Sq, Skv, Hq, Hkv, D, Dv, kw):
    """``f_vmem_*``: per query tile Q once, per visited kv tile K and V
    (data elements, padding not counted); bf16 staged as bf16 with no
    probability buffer, f32 as f32 with the 64 × 64 probabilities."""
    tdt = DTYPES[dt][1]
    tq = tfa.TILE_Q[tdt]
    bk = 32
    meta = functools.partial(torch.empty, dtype=tdt, device="meta")
    c = count_fn(functools.partial(tops.flash_attention, block_q=32,
                                   block_k=bk, **kw),
                 meta(B, Sq, Hq, D), meta(B, Skv, Hkv, D),
                 meta(B, Skv, Hkv, Dv))
    visited = B * Hq * _tiles_with_unmasked_pairs(
        Sq, Skv, kw["causal"], kw.get("window"), tq)
    want = B * Hq * -(-Sq // tq) * tq * D + visited * 64 * (D + Dv)
    if dt == "float32":
        want += visited * 64 * 64
    assert c[f"f_vmem_contig_{dt}_store"] == want
    other = "bfloat16" if dt == "float32" else "float32"
    assert c[f"f_vmem_contig_{other}_store"] == 0


def _tile_pairs_with_unmasked(rows_n, cols_n, keep, tile_r, tile_c):
    """(row tile, column tile) pairs of a [rows_n, cols_n] mask ``keep``
    that hold at least one unmasked pair, by brute force."""
    nr, nc = -(-rows_n // tile_r), -(-cols_n // tile_c)
    padded = np.zeros((nr * tile_r, nc * tile_c), bool)
    padded[:rows_n, :cols_n] = keep
    return int(padded.reshape(nr, tile_r, nc, tile_c).any(axis=(1, 3)).sum())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,Dv,kw", [
    (2, 256, 256, 8, 2, 64, 64, dict(causal=True)),
    (1, 512, 512, 4, 2, 256, 256, dict(causal=True, window=160)),
    (1, 256, 256, 4, 4, 128, 128, dict(causal=False)),
    (1, 256, 256, 4, 2, 64, 64, dict(causal=False, window=40)),
    (1, 160, 96, 4, 2, 48, 32, dict(causal=True, window=40)),
    (1, 96, 160, 8, 1, 192, 128, dict(causal=True)),
    (1, 130, 100, 4, 2, 64, 64, dict(causal=True, softcap=50.0)),
    (1, 192, 192, 4, 2, 64, 64, dict(causal=True, window=0)),
    (1, 160, 160, 4, 2, 48, 33, dict(causal=True, window=40)),
    (1, 8192, 8192, 16, 8, 256, 256,
     dict(causal=True, window=4096, softcap=50.0)),
])
def test_flash_attention_bwd_staging_term_counts_visited_tiles(
        dt, B, Sq, Skv, Hq, Hkv, D, Dv, kw):
    """The backward's ``f_vmem_*`` term follows the CUDA kernel's route:
    each pass stages its row tile once and, per column tile its rows can
    see (counted here by brute force over the mask, both ways round), the
    column tiles — bf16 with D and Dv multiples of 8 in three passes (Δ,
    dQ, fused dK+dV) of 64-row tiles, other bf16 head dims in four (dK
    and dV apart, the dV pass staging k alone) with 32-row column steps,
    f32 in four of 32-row tiles plus W in the dQ, dK and dV passes."""
    tdt = DTYPES[dt][1]
    if dt == "float32":
        rows, cols, fused = 32, 32, False
    elif D % 8 == 0 and Dv % 8 == 0:
        rows, cols, fused = 64, 64, True
    else:
        rows, cols, fused = 64, 32, False
    assert tfa.bwd_route(tdt, D, Dv) == (
        "fma" if dt == "float32" else "wgmma" if fused else "mma_sync")
    meta = functools.partial(torch.empty, dtype=tdt, device="meta")
    options = dict(dict(window=None, softcap=None), **kw)
    c = count_fn(functools.partial(tfa.flash_attention_bwd, scale=0.125,
                                   block_q=32, block_k=32, **options),
                 meta(B, Sq, Hq, Dv), meta(B, Sq, Hq, D),
                 meta(B, Skv, Hkv, D), meta(B, Skv, Hkv, Dv))
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if kw["causal"]:
        keep &= qpos >= kpos
    if kw.get("window") is not None:
        keep &= qpos - kpos < kw["window"]
    dq_steps = _tile_pairs_with_unmasked(Sq, Skv, keep, rows, cols)
    dkv_steps = _tile_pairs_with_unmasked(Skv, Sq, keep.T, rows, cols)
    q_rows = B * Hq * -(-Sq // rows) * rows
    k_rows = B * Hkv * -(-Skv // rows) * rows
    want = (2 * q_rows * (D + Dv) + k_rows * (D + Dv + (0 if fused else D))
            + B * Hq * (2 * dq_steps + (1 if fused else 2) * dkv_steps)
            * cols * (D + Dv))
    if dt == "float32":
        want += B * Hq * (dq_steps + 2 * dkv_steps) * rows * cols
    assert c[f"f_vmem_contig_{dt}_store"] == want
    other = "bfloat16" if dt == "float32" else "float32"
    assert c[f"f_vmem_contig_{other}_store"] == 0


def _attn_program(q, k, v, m_prev, l_prev, acc, iq, ik, *, scale, causal,
                  window, softcap, bq, bk):
    """``_flash_kernel``'s per-program body with its refs as arrays."""
    s = jax.lax.dot_general(q, k, (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.float32) * scale
    if softcap is not None:
        s = softcap * jnp.tanh(s / softcap)
    q_pos = iq * bq + jax.lax.broadcasted_iota(jnp.int32, (bq, bk), 0)
    k_pos = ik * bk + jax.lax.broadcasted_iota(jnp.int32, (bq, bk), 1)
    mask = jnp.ones((bq, bk), jnp.bool_)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = jnp.where(mask, s, NEG_INF)
    m_new = jnp.maximum(m_prev, jnp.max(s, axis=1))
    p = jnp.exp(s - m_new[:, None])
    p = jnp.where(s <= NEG_INF / 2, 0.0, p)
    corr = jnp.exp(m_prev - m_new)
    l_new = l_prev * corr + jnp.sum(p, axis=1)
    acc = acc * corr[:, None] + jax.lax.dot_general(
        p.astype(v.dtype), v, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return m_new, l_new, acc


def _attn_done(l_prev, acc, dtype):
    """``_flash_kernel``'s last-kv-step branch."""
    l_prev = jnp.maximum(l_prev, 1e-30)
    return (acc / l_prev[:, None]).astype(dtype)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,bq,bk", [
    (2, 256, 8, 2, 64, 64, 64, 64), (1, 128, 4, 4, 48, 40, 64, 32)])
def test_flash_attention_arithmetic_matches_reference_body(
        dt, kw, B, S, Hq, Hkv, D, Dv, bq, bk):
    jdt, tdt = DTYPES[dt]
    sd = jax.ShapeDtypeStruct
    kw = {"window": None, "softcap": None, **kw}
    with jax.disable_jit():
        body = jcount_fn(
            functools.partial(_attn_program, scale=0.125, bq=bq, bk=bk,
                              **kw),
            sd((bq, D), jdt), sd((bk, D), jdt), sd((bk, Dv), jdt),
            sd((bq,), jnp.float32), sd((bq,), jnp.float32),
            sd((bq, Dv), jnp.float32), sd((), jnp.int32),
            sd((), jnp.int32))
        done = jcount_fn(functools.partial(_attn_done, dtype=jdt),
                         sd((bq,), jnp.float32), sd((bq, Dv), jnp.float32))
    nq, nk = S // bq, S // bk
    want = _sum(_scaled(_arith(body), B * Hq * nq * nk),
                _scaled(_arith(done), B * Hq * nq))
    meta = functools.partial(torch.empty, dtype=tdt, device="meta")
    got = count_fn(functools.partial(tops.flash_attention, block_q=bq,
                                     block_k=bk, **kw),
                   meta(B, S, Hq, D), meta(B, S, Hkv, D), meta(B, S, Hkv, Dv))
    assert _diff(want, got) == {}


def _ssd_program(x, da, bm, cm, state, *, chunk):
    """``_ssd_kernel``'s per-program body with its refs as arrays."""
    la = jnp.cumsum(da)
    li, lj = la[:, None], la[None, :]
    ii = jax.lax.broadcasted_iota(jnp.int32, (chunk, chunk), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (chunk, chunk), 1)
    decay = jnp.where(ii >= jj, jnp.exp(li - lj), 0.0)
    cb = jax.lax.dot_general(cm, bm, (((1,), (1,)), ((), ())),
                             preferred_element_type=jnp.float32)
    y_intra = jax.lax.dot_general(cb * decay, x, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
    y_inter = jax.lax.dot_general(
        cm, state, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32) * jnp.exp(la)[:, None]
    w = jnp.exp(la[-1] - la)
    ds = jax.lax.dot_general(x * w[:, None], bm, (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return y_intra + y_inter, state * jnp.exp(la[-1]) + ds


@pytest.mark.parametrize("B,S,H,P,N,chunk",
                         SSD_SHAPES + [(1, 8192, 112, 64, 64, 256)])
def test_mamba2_ssd_cost_rule(B, S, H, P, N, chunk):
    c = count_fn(functools.partial(tops.mamba2_ssd, chunk=chunk),
                 f32(B, S, H, P), f32(B, S, H), f32(B, S, H, N),
                 f32(B, S, H, N))
    programs = B * H * (S // chunk)
    # every block changes every step: one read of x, dt·A, B, C and one
    # write of y per token
    assert c[BYTES_IN_FEATURE] == 4 * B * S * H * (P + 1 + 2 * N)
    assert c[BYTES_OUT_FEATURE] == 4 * B * S * H * P
    assert c["f_mem_contig_float32_load"] == B * S * H * (P + 1 + 2 * N)
    assert c["f_mem_contig_float32_store"] == B * S * H * P
    assert c["f_sync_grid_programs"] == programs
    # the CUDA passes' staging at the kernel's own chunk (one tile of at
    # most 64 rows): (a) x and B, x scaled in place, la and its weights;
    # (c) C, the state, la, B, x and a 64 × 64 tile of (C·Bᵀ)∘decay
    lk = tssd.inner_chunk(chunk)
    assert lk <= 64
    assert c["f_vmem_contig_float32_store"] == B * H * (S // lk) * (
        lk * (2 * P + N + 2) + lk * N + N * P + lk + lk * (N + P) + 64 * 64)
    sd = functools.partial(jax.ShapeDtypeStruct, dtype=jnp.float32)
    with jax.disable_jit():
        body = jcount_fn(functools.partial(_ssd_program, chunk=chunk),
                         sd((chunk, P)), sd((chunk,)), sd((chunk, N)),
                         sd((chunk, N)), sd((P, N)))
    assert _diff(_scaled(_arith(body), programs), c) == {}


def _slstm_program(g_in, r2, b, *, steps, H, dh):
    """``_slstm_kernel``'s body for one batch row, refs as arrays."""
    z = jnp.zeros((H, dh), jnp.float32)
    y = jnp.zeros((steps, H, dh), g_in.dtype)

    def step(t, carry):
        c, n, m, h, y = carry
        rec = jax.lax.dot_general(h[:, None, :], r2,
                                  (((2,), (1,)), ((0,), (0,))),
                                  preferred_element_type=jnp.float32)
        rec = rec.reshape(H, 4, dh).transpose(1, 0, 2)
        g = g_in[t] + rec + b
        li, lf, z_raw, o_raw = g[0], g[1], g[2], g[3]
        lf = jax.nn.log_sigmoid(lf)
        m_new = jnp.maximum(lf + m, li)
        ip = jnp.exp(li - m_new)
        fp = jnp.exp(lf + m - m_new)
        c_new = fp * c + ip * jnp.tanh(z_raw)
        n_new = fp * n + ip
        h_new = jax.nn.sigmoid(o_raw) * c_new / jnp.maximum(n_new, 1e-6)
        return c_new, n_new, m_new, h_new, y.at[t].set(h_new)

    return jax.lax.fori_loop(0, steps, step, (z, z, z, z, y))[-1]


@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES + [(8, 4096, 4, 192)])
def test_slstm_cell_cost_rule(B, S, H, dh):
    c = count_fn(tops.slstm_cell, f32(B, S, 4, H, dh), f32(H, dh, 4, dh),
                 f32(4, H, dh))
    # g_in and y per batch row; r and b fetched once for all programs
    assert c[BYTES_IN_FEATURE] == 4 * (B * S * 4 * H * dh + H * dh * 4 * dh
                                       + 4 * H * dh)
    assert c[BYTES_OUT_FEATURE] == 4 * B * S * H * dh
    assert c["f_sync_grid_programs"] == B
    assert c["f_sync_loop_steps"] == B * S
    # the CUDA kernel: r[h] into registers once per (batch row, head), and
    # every step the four gate sums of each unit and each new h value
    # into each block of the cluster
    assert c["f_vmem_contig_float32_store"] == \
        B * H * 4 * dh * dh + B * S * H * dh * (4 + tsc.cluster_blocks(dh))
    if S > 64:
        return
    sd = functools.partial(jax.ShapeDtypeStruct, dtype=jnp.float32)
    args = (sd((S, 4, H, dh)), sd((H, dh, 4 * dh)), sd((4, H, dh)))
    body = functools.partial(_slstm_program, steps=S, H=H, dh=dh)
    with jax.disable_jit():
        inlined = jcount_fn(body, *args)
    assert _diff(_scaled(_arith(inlined), B), c) == {}
    # traced as written, the loop is a scan: S steps per program, plus its
    # int32 counter and the index arithmetic of g_in[t] and y.at[t] (one
    # int32 add each per step), which the rule leaves out as the port's
    # loops have none (COUNT_DIFFERENCES in test_torch_counting.py);
    # log_sigmoid and sigmoid are nested jits the walker does not open
    scanned = jcount_fn(body, *args)
    assert scanned["f_sync_loop_steps"] * B == c["f_sync_loop_steps"]
    assert scanned["f_op_int32_add"] == 3 * S


def test_targets_price_all_eight_reference_names():
    from repro.analysis.targets import kernel_targets as jtargets
    from repro_torch.analysis.targets import kernel_targets
    port = {t.name: t for t in kernel_targets()}
    assert list(port) == [t.name for t in jtargets()]
    for name in ("kernels.ops.flash_attention", "kernels.ops.mamba2_ssd",
                 "kernels.ops.slstm_cell"):
        t = port[name]
        c = count_fn(t.fn, *t.args)
        assert c["f_op_float32_madd"] > 0 and c[BYTES_IN_FEATURE] > 0


def test_predict_cli_prices_the_model_kernels_with_zero_timings(tmp_path):
    from repro_torch.profiles.cli import main as cli_main
    profile = tmp_path / "apex.json"
    assert cli_main(["--zoo", "--smoke", "--synthetic", "apex",
                     "--trials", "2", "--out", str(profile)]) == 0
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibrate", "predict",
         str(profile), "--kernel", "kernels.ops.flash_attention",
         "--kernel", "kernels.ops.mamba2_ssd",
         "--kernel", "kernels.ops.slstm_cell", "--device", "cpu",
         "--expect-zero-timings", "--explain", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "timings_performed=0 batched_evals=1" in out.stdout
    for name in ("flash_attention", "mamba2_ssd", "slstm_cell"):
        assert f"kernels.ops.{name}" in out.stdout


# ---------------------------------------------------------------------------
# the port's copy of the configs
# ---------------------------------------------------------------------------


def _fields(cfg):
    """A config as nested plain values, with each dataclass's name."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__,
                {f.name: _fields(getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)})
    if isinstance(cfg, dict):
        return {k: _fields(v) for k, v in cfg.items()}
    return cfg


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert _fields(tconfigs.get_config(arch)) \
        == _fields(jconfigs.get_config(arch))
    assert _fields(tconfigs.get_smoke_config(arch)) \
        == _fields(jconfigs.get_smoke_config(arch))
    assert [s.name for s in tconfigs.shapes_for(tconfigs.get_config(arch))] \
        == [s.name for s in jconfigs.shapes_for(jconfigs.get_config(arch))]


def test_config_registry_and_shapes_equal_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert [_fields(s) for s in tconfigs.ALL_SHAPES] \
        == [_fields(s) for s in jconfigs.ALL_SHAPES]
    assert _fields(tconfigs.RunConfig()) == _fields(jconfigs.RunConfig())
    # the parameter counts come from the port's model schemas
    assert tconfigs.get_config("gemma2-9b").param_count() \
        == jconfigs.get_config("gemma2-9b").param_count()
    # the widths chip_smoke.py takes from the port's configs
    gemma = tconfigs.get_config("gemma2-9b").attention
    assert (gemma.num_heads, gemma.num_kv_heads, gemma.head_dim,
            gemma.window, gemma.logit_softcap) == (16, 8, 256, 4096, 50.0)
    zamba = tconfigs.get_config("zamba2-7b")
    assert (zamba.ssm.num_heads(zamba.d_model), zamba.ssm.head_dim,
            zamba.ssm.d_state, zamba.ssm.chunk_size) == (112, 64, 64, 256)
    xl = tconfigs.get_config("xlstm-125m")
    assert (xl.xlstm.num_heads, xl.d_model // xl.xlstm.num_heads) == (4, 192)
    assert math.isclose(tconfigs.get_config("gemma2-9b").final_logit_softcap,
                        30.0)
