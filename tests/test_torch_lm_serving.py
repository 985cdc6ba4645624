"""Serving the port's language models on the CPU, against the reference.

Per architecture at its smoke config, with the reference's weights
carried over: ``prefill`` of 16 tokens into a 32-slot cache, then one
``decode_step`` — the logits of both and every returned cache leaf equal
the reference's.  The port's own prefill-then-decode equals its full
forward within ``tests/test_serving.py``'s ``TOL``; the gemma ring cache
with the prompt past the window; ``tests/test_ring_cache.py``'s two
properties against the reference functions; and the serving launcher
``python -m repro_torch.launch.serve --smoke --device cpu``.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.testing.proptest import hypothesis, st
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention, mamba2_ssd, slstm_cell
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.models.param import carry

ROOT = Path(__file__).resolve().parents[1]
# tests/test_serving.py's tolerances: decode against the full forward
TOL = {
    "zamba2-7b": 2e-2, "internvl2-2b": 2e-3, "granite-8b": 2e-3,
    "yi-6b": 2e-3, "nemotron-4-15b": 2e-3, "gemma2-9b": 2e-3,
    "whisper-tiny": 2e-3, "xlstm-125m": 5e-2, "arctic-480b": 5e-2,
    "deepseek-v2-236b": 5e-2,
}
REL = 1e-4
B, S, S_CACHE = 2, 17, 32


def n_front(cfg):
    return cfg.frontend.num_positions \
        if cfg.frontend.kind != "none" and cfg.encdec is None else 0


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.frontend.kind != "none":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend.num_positions, cfg.frontend.d_frontend)
        ).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's smoke params, a batch, and its prefill of S − 1
    tokens then decode of token S − 1: logits and caches (numpy), one
    compile per arch."""
    cfg = jget_smoke(arch)
    params = jlm.init(jax.random.PRNGKey(0), cfg)
    batch = make_batch(cfg)
    cur = S - 1 + n_front(cfg)

    @jax.jit
    def run(p, b):
        pre = dict(b, tokens=b["tokens"][:, : S - 1])
        cache, pre_logits = jlm.prefill(p, cfg, jlm.zero_cache(cfg, B,
                                                               S_CACHE), pre)
        dec_cache, dec_logits = jlm.decode_step(
            p, cfg, cache, b["tokens"][:, S - 1:],
            jnp.asarray(cur, jnp.int32))
        return pre_logits, cache, dec_logits, dec_cache

    out = run(params, {k: jnp.asarray(v) for k, v in batch.items()})
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(params), batch, as_np(out)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    return float(np.max(np.abs(got.astype(np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-6))


def _same_cache(got, want, path=()):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _same_cache(got[k], want[k], path + (k,))
        else:
            g = got[k].float().numpy()
            assert g.shape == want[k].shape, path + (k,)
            scale = np.max(np.abs(want[k])) + 1e-6
            assert np.max(np.abs(g - want[k])) <= REL * scale, path + (k,)


def _port_serve(arch, params, batch):
    cfg = get_smoke_config(arch)
    tb = to_torch(batch)
    pre = dict(tb, tokens=tb["tokens"][:, : S - 1])
    cache, pre_logits = lm.prefill(params, cfg,
                                   lm.zero_cache(cfg, B, S_CACHE), pre)
    # the prefill's cache, before the decode step writes into it
    pre_cache = jax.tree.map(lambda t: t.clone(), cache)
    dec_cache, dec_logits = lm.decode_step(
        params, cfg, cache, tb["tokens"][:, S - 1:], S - 1 + n_front(cfg))
    return pre_logits, pre_cache, dec_logits, dec_cache


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    params, batch, (w_pre, w_cache, w_dec, w_dec_cache) = reference(arch)
    pre, cache, dec, dec_cache = _port_serve(arch, carry(params, "cpu"),
                                             batch)
    assert pre.shape == w_pre.shape and dec.shape == w_dec.shape
    assert _rel(pre, w_pre) < REL, arch
    assert _rel(dec, w_dec) < REL, arch
    _same_cache(cache, w_cache)
    _same_cache(dec_cache, w_dec_cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_forward(arch):
    """tests/test_serving.py's invariant on the port alone."""
    params, batch, _ = reference(arch)
    params = carry(params, "cpu")
    cfg = get_smoke_config(arch)
    full, _, _ = lm.forward(params, cfg, to_torch(batch), mode="train",
                            q_chunk=8, kv_chunk=8)
    _, _, dec, _ = _port_serve(arch, params, batch)
    assert _rel(dec[:, 0], full[:, -1].numpy()) < TOL[arch], arch


def test_local_ring_cache_matches_full_and_reference():
    """gemma2's local layers keep a 16-slot ring (the smoke window) while
    the prompt is 24 tokens and 6 more are decoded."""
    cfg, jcfg = get_smoke_config("gemma2-9b"), jget_smoke("gemma2-9b")
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    params = carry(jax.tree.map(np.asarray, jparams), "cpu")
    S_pre, n_dec = 24, 6
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S_pre + n_dec)).astype(np.int32)

    cache = lm.zero_cache(cfg, B, 64)
    assert cache["body"]["b0"]["attn"]["k"].shape[2] == 16   # local: ring
    assert cache["body"]["b1"]["attn"]["k"].shape[2] == 64
    t = torch.from_numpy(tokens).long()
    cache, _ = lm.prefill(params, cfg, cache, {"tokens": t[:, :S_pre]},
                          q_chunk=8, kv_chunk=8)
    jcache, _ = jlm.prefill(jparams, jcfg, jlm.zero_cache(jcfg, B, 64),
                            {"tokens": jnp.asarray(tokens[:, :S_pre])})
    # the ring holds the trailing window, slot s = position p, p % 16 == s
    _same_cache(cache, jax.tree.map(np.asarray, jcache))
    full, _, _ = lm.forward(params, cfg, {"tokens": t}, mode="train")
    for i in range(n_dec):
        pos = S_pre + i
        cache, lg = lm.decode_step(params, cfg, cache, t[:, pos: pos + 1],
                                   pos)
        jcache, jlg = jlm.decode_step(
            jparams, jcfg, jcache, jnp.asarray(tokens[:, pos: pos + 1]),
            jnp.asarray(pos, jnp.int32))
        assert _rel(lg, np.asarray(jlg)) < REL, i
        want = full[:, pos].numpy()
        diff = float(np.max(np.abs(lg[:, 0].numpy() - want)))
        assert diff < 2e-2 * (float(np.max(np.abs(want))) + 1e-3), (i, diff)


@hypothesis.given(st.integers(4, 48), st.sampled_from([8, 16]))
@hypothesis.settings(max_examples=20, deadline=None)
def test_ring_decode_matches_linear_cache(cur, W):
    """The port's ring-buffer decode attention equals the reference's
    full-cache attention under the same window mask."""
    Bz, Hq, Hkv, D, S_full = 2, 4, 2, 16, 64
    rng = np.random.default_rng(cur * 31 + W)
    k_full = rng.standard_normal((Bz, S_full, Hkv, D)).astype(np.float32)
    v_full = rng.standard_normal((Bz, S_full, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((Bz, 1, Hq, D)).astype(np.float32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k_full),
                                    jnp.asarray(v_full), jnp.asarray(cur),
                                    window=W)
    abs_pos = layers.ring_slot_positions(cur, W, "cpu")
    k_ring = np.zeros((Bz, W, Hkv, D), np.float32)
    v_ring = np.zeros((Bz, W, Hkv, D), np.float32)
    for s, p in enumerate(abs_pos.tolist()):
        if p >= 0:
            k_ring[:, s], v_ring[:, s] = k_full[:, p], v_full[:, p]
    got = layers.decode_attention_at_positions(
        torch.from_numpy(q), torch.from_numpy(k_ring),
        torch.from_numpy(v_ring), abs_pos, cur, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@hypothesis.given(st.integers(0, 200))
@hypothesis.settings(max_examples=30, deadline=None)
def test_ring_slot_position_recovery(cur):
    """The port's slot positions are the reference's formula's, unique and
    within (cur − W, cur]."""
    W = 16
    slots = np.arange(W)
    want = cur - np.asarray(jax.lax.rem(cur - slots + W * 8, W))
    abs_pos = layers.ring_slot_positions(cur, W, "cpu").numpy()
    np.testing.assert_array_equal(abs_pos, want)
    valid = abs_pos >= 0
    assert np.all(abs_pos[valid] <= cur)
    assert np.all(abs_pos[valid] > cur - W)
    assert np.all((abs_pos[valid] % W) == slots[valid])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_launcher_on_the_host(arch):
    before = serve.launch_counts()
    res = serve.serve(get_smoke_config(arch), batch=2, prompt_len=20,
                      tokens=4, device="cpu")
    assert serve.launch_counts() == before      # plain versions on the host
    assert len(res["generated"]) == 2 and len(res["generated"][0]) == 4
    assert res["prefill_ms"] > 0 and res["decode_ms_per_token"] > 0
    assert res["launches"]["prefill"] == dict.fromkeys(serve.KERNELS, 0)
    # the greedy tokens are the model's: recompute the first one
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, cfg)
    req = serve.make_request(cfg, 2, 20, gen, "cpu")
    logits, _, _ = lm.forward(params, cfg, req)
    assert logits[:, -1].argmax(-1).tolist() \
        == [row[0] for row in res["generated"]]


def test_serve_cli_on_the_host_and_its_refusals():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-125m", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--tokens", "3"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])["serve"]
    assert res["arch"] == "xlstm-125m" and res["device"] == "cpu"
    assert "mesh={'data': 1, 'model': 1}" in out.stdout
    with pytest.raises(ValueError, match="1 device"):
        serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--model-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", "yi-6b", "--smoke"])
    assert {flash_attention.__name__, mamba2_ssd.__name__,
            slstm_cell.__name__} == {m.__name__
                                     for m in serve.KERNELS.values()}


def test_served_attention_check_separates_bf16_rounding_from_a_wrong_window():
    """chip_smoke.py holds a served model's bf16 attention against the
    plain version in float64 (``attention_excess``).  Its tolerance
    passes what bf16 costs — probabilities rounded to bf16 before P·V,
    f32 sums, the output rounded — over a long causal softmax, and fails
    a kernel that drops the first key of the last row only (a window one
    short), which the element-wise bf16 tolerance of 2e-2 lets through."""
    import importlib.util
    import math
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels.ref import attention_ref
    rng = np.random.default_rng(7)
    S_, H, D = 1024, 2, 256
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S_, H, D))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    kw = dict(causal=True, softcap=50.0, scale=1 / math.sqrt(D))
    want = attention_ref(q.double(), k.double(), v.double(), **kw)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * kw["scale"]
    s = 50.0 * torch.tanh(s / 50.0)
    s = s.masked_fill(~torch.ones(S_, S_, dtype=torch.bool).tril(),
                      -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
    bf16_kernel = (o / p.sum(-1)[..., None].transpose(1, 2)).bfloat16()
    short = attention_ref(q, k, v, window=S_ - 1, **kw)
    tol = cs.LM_ATTN_BF16_TOL
    assert cs.attention_excess(bf16_kernel, want, **tol) < 0.5
    assert cs.attention_excess(short, want, **tol) > 1
    assert cs.excess(short, want, **cs.TOL["bfloat16"]) < 1
