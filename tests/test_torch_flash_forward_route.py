"""The attention forward's three CUDA routes, on the CPU: which operands
take the wgmma route (``flash_attention.route``, the rule the backward
follows too), what the cost rule's staging term counts on each route
(``kernelcost.flash_attention_cost``), and the P·V tile's and the
launchers' host side; ``tests/test_torch_kernels.py`` holds that no route
moves a feature the reference counts.  The kernels themselves run only
on the card (``tests/test_torch_gpu.py``)."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernelcost
from repro_torch.core.counting import count_fn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.testing.variants import ATTN_KW, ATTN_SHAPES

ROOT = Path(__file__).resolve().parents[1]

#: head dims at and around the wgmma route's boundaries: multiples of 8
#: (zamba2-7b's 112, deepseek's 192, gemma2-9b's 256) and 100
DIMS = (8, 100, 112, 192, 256)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_route_takes_wgmma_where_tma_describes_the_operands(dt, aligned):
    """bf16 with D and Dv multiples of 8 and aligned operands takes the
    wgmma route, any other bf16 mma.sync, f32 the FMA route; both
    directions follow the one rule."""
    tdt = DTYPES[dt]
    for d in DIMS:
        for dv in DIMS:
            want = ("fma" if dt == "float32" else
                    "wgmma" if aligned and d % 8 == 0 and dv % 8 == 0
                    else "mma_sync")
            assert tfa.route(tdt, d, dv, aligned=aligned) == want, (d, dv)
            if aligned:
                assert tfa.route(tdt, d, dv) == want


def _visited(sq, skv, causal, window, tile_q):
    """(query tile, kv tile) pairs that hold an unmasked pair, by brute
    force over the reference's mask."""
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    nq, nk = -(-sq // tile_q), -(-skv // 64)
    padded = np.zeros((nq * tile_q, nk * 64), bool)
    padded[:sq, :skv] = keep
    return int(padded.reshape(nq, tile_q, nk, 64).any(axis=(1, 3)).sum())


def _staging(route, B, Sq, Skv, Hq, D, Dv, causal, window):
    """Elements staged in shared memory, written out from the routes'
    layouts: per 128-row (f32: 64-row) query tile Q once, per kv tile the
    rows see K and V (data elements, padding not counted); the wgmma
    route's TMA ring and the mma.sync route's cp.async ring stage the same
    tiles and keep P in registers, f32 also stages the 64 × 64
    probabilities."""
    tq = 64 if route == "fma" else 128
    visited = B * Hq * _visited(Sq, Skv, causal, window, tq)
    staged = B * Hq * -(-Sq // tq) * tq * D + visited * 64 * (D + Dv)
    if route == "fma":
        staged += visited * tq * 64
    return staged


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,Dv,kw", [
    (1, 160, 160, 4, 2, 112, 112, dict(causal=True)),
    (1, 96, 160, 8, 1, 192, 128, dict(causal=False)),
    (1, 128, 128, 4, 2, 100, 60, dict(causal=True, window=48)),
    (2, 64, 64, 2, 1, 8, 8, dict(causal=True, softcap=50.0)),
    (1, 512, 512, 4, 2, 256, 256, dict(causal=True, window=24)),
    (1, 8192, 8192, 32, 32, 112, 112, dict(causal=True)),
])
def test_staging_term_follows_the_route(dt, B, Sq, Skv, Hq, Hkv, D, Dv, kw):
    """The rule's ``f_vmem_*`` term is its route's closed form (the
    route from ``flash_attention.route`` on the shapes, operands taken
    as aligned), in the operands' dtype only."""
    tdt = DTYPES[dt]
    route = tfa.route(tdt, D, Dv)
    meta = functools.partial(torch.empty, dtype=tdt, device="meta")
    args = (meta(B, Sq, Hq, D), meta(B, Skv, Hkv, D), meta(B, Skv, Hkv, Dv))
    c = count_fn(functools.partial(tops.flash_attention, block_q=32,
                                   block_k=32, **kw), *args)
    want = _staging(route, B, Sq, Skv, Hq, D, Dv, kw["causal"],
                    kw.get("window"))
    assert c[f"f_vmem_contig_{dt}_store"] == want
    other = "bfloat16" if dt == "float32" else "float32"
    assert c[f"f_vmem_contig_{other}_store"] == 0
    rule = kernelcost.flash_attention_cost(
        *args, kw["causal"], kw.get("window"), kw.get("softcap"), 0.125, 32,
        32)
    assert rule[f"f_vmem_contig_{dt}_store"] == want


def test_bf16_routes_stage_the_same_tiles():
    """Where a shape could take either bf16 route (an aligned view or
    not), the two stage the same elements: the term needs no alignment."""
    for d, dv in ((112, 112), (256, 256), (192, 128)):
        assert _staging("wgmma", 1, 512, 512, 4, d, dv, True, 100) == \
            _staging("mma_sync", 1, 512, 512, 4, d, dv, True, 100)


@pytest.mark.parametrize("n", [64, 128, 192, 256])
def test_pv_tile_check_on_the_host_is_the_rounded_chain(n):
    """``wgmma_pv_tile``'s plain version: the scores rounded to bf16
    before the product with v, as the wgmma route's P; integer inputs in
    {-1, 0, 1} make every step exact, so the card's kernel is held to it
    bit for bit, and a P fragment out of place shows."""
    rng = np.random.default_rng(n)
    q, k = (torch.from_numpy(rng.integers(-1, 2, (64, 256)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.integers(-1, 2, (64, n)).astype(
        np.float32)).to(torch.bfloat16)
    got = tfa.wgmma_pv_tile(q, k, v)
    want = (q.double() @ k.double().T) @ v.double()
    assert got.dtype == torch.float32 and got.shape == (64, n)
    assert torch.equal(got.double(), want)
    # a transposed P (keys for rows) is a different product
    assert not torch.equal(got.double(),
                           (q.double() @ k.double().T).T @ v.double())
    with pytest.raises(ValueError):
        tfa.wgmma_pv_tile(q, k, v[:, :48])


@pytest.mark.parametrize("launcher", ["flash_attention_cuda",
                                      "flash_attention_lse_cuda",
                                      "flash_attention_mma_cuda"])
def test_launchers_check_operands_before_picking_an_entry(launcher):
    """Every forward launcher runs the operand check before it picks a C
    entry or loads the library, so what the kernels do not take raises
    the check's error on any device (here the host, where nothing
    launches)."""
    fn = getattr(tfa, launcher)
    extra = (64, 64) if launcher == "flash_attention_cuda" else ()
    f64 = [torch.ones(1, 64, 2, 16, dtype=torch.float64)] * 3
    with pytest.raises(TypeError):
        fn(*f64, True, None, None, 0.25, *extra)
    f32 = [torch.ones(1, 64, 2, 16)] * 3
    with pytest.raises(ValueError, match="window"):
        fn(*f32, True, -1, None, 0.25, *extra)
    with pytest.raises(ValueError):
        fn(torch.ones(1, 64, 2, 512), *[torch.ones(1, 64, 1, 512)] * 2,
           True, None, None, 0.25, *extra)
    if launcher == "flash_attention_mma_cuda":
        with pytest.raises(TypeError, match="bfloat16"):
            fn(*f32, True, None, None, 0.25)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("kw", ATTN_KW)
def test_smoke_plain_by_head_is_the_plain_version(kw):
    """``chip_smoke.py`` holds both bf16 routes at the real-size layers
    against the plain version in f32 one kv head at a time
    (``attention_f32_by_head``); that is the whole plain version's
    output, GQA, MHA and MQA, with the window and softcap passed on."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    for B, S, Hq, Hkv, D in ATTN_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
            np.float32)).bfloat16() for h in (Hq, Hkv, Hkv))
        want = tref.attention_ref(q.float(), k.float(), v.float(), **kw)
        got = cs.attention_f32_by_head(tref, kw, q, k, v)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_smoke_mma_route_passes_the_options_and_the_plain_scale():
    """``chip_smoke.mma_route`` calls ``flash_attention_mma_cuda`` with a
    case's options, the plain version's defaults (causal, scale D^-1/2)
    where the case leaves them out."""
    cs = _chip_smoke()
    seen = []

    class Stub:
        @staticmethod
        def flash_attention_mma_cuda(*args):
            seen.append(args[3:])
            return args[0]

    q, k, v = (torch.zeros(1, 8, 2, 64) for _ in range(3))
    for kw in ATTN_KW + [dict(causal=False, scale=0.5)]:
        assert cs.mma_route(Stub, kw)(q, k, v) is q
    assert seen == [(kw.get("causal", True), kw.get("window"),
                     kw.get("softcap"), kw.get("scale", 64 ** -0.5))
                    for kw in ATTN_KW + [dict(causal=False, scale=0.5)]]
