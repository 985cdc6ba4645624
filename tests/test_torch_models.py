"""The port's language models (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU, with the reference's weights
carried over leaf for leaf.

Per architecture at its smoke config: ``forward`` (train mode) logits
within 1e-4 × max |logit| and ``lm_loss``/aux within 1e-4; on the host
the hand-kernel wrappers take their plain versions and launch nothing.
For all ten full configs: ``model_schema``/``cache_schema`` leaf for leaf
(shape, axes, initializer) and the parameter, active-parameter and FLOP
counts exactly equal.  The state-returning plain versions of the SSD
and sLSTM kernels against the reference's scans.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import shapes_for as jshapes_for
from repro.models import counting as jcounting
from repro.models import lm as jlm
from repro.models import param as jparam
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.analysis.kernelcost import BYTES_OUT_FEATURE
from repro_torch.analysis.targets import f32
from repro_torch.configs import get_config, get_smoke_config, shapes_for
from repro_torch.core.counting import count_fn
from repro_torch.kernels import flash_attention, mamba2_ssd, ops, ref
from repro_torch.kernels import slstm_cell
from repro_torch.models import counting, layers, lm
from repro_torch.models.param import ParamSpec, carry, init_tree

REL = 1e-4
B, S = 2, 32


def make_batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.frontend.kind != "none":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend.num_positions, cfg.frontend.d_frontend)
        ).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's smoke params (numpy), batch, forward logits, loss
    and metrics — once per arch."""
    cfg = jget_smoke(arch)
    params = jlm.init(jax.random.PRNGKey(0), cfg)
    batch = make_batch(cfg)

    @jax.jit
    def run(p, b):
        logits, aux, _ = jlm.forward(p, cfg, b, mode="train")
        loss, metrics = jlm.lm_loss(p, cfg, b)
        return logits, aux, loss, metrics

    logits, aux, loss, metrics = run(params, to_jax(batch))
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(params), batch, np.asarray(logits), as_np(aux), \
        float(loss), as_np(metrics)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    params, batch, want, want_aux, _, _ = reference(arch)
    cfg = get_smoke_config(arch)
    logits, aux, cache = lm.forward(carry(params, "cpu"), cfg,
                                    to_torch(batch), mode="train")
    assert cache is None
    assert logits.shape == (B, S, lm.padded_vocab(cfg))
    assert bool(torch.isfinite(logits).all())
    assert _rel(logits.numpy(), want) < REL, arch
    assert set(aux) == set(want_aux)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=REL, atol=1e-7)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_matches_reference(arch):
    params, batch, _, _, want_loss, want_metrics = reference(arch)
    cfg = get_smoke_config(arch)
    loss, metrics = lm.lm_loss(carry(params, "cpu"), cfg, to_torch(batch))
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=REL)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=REL, atol=1e-7)


def test_host_forward_launches_no_kernel():
    before = [m.launches for m in (flash_attention, mamba2_ssd, slstm_cell)]
    for arch in ("gemma2-9b", "zamba2-7b", "xlstm-125m"):
        params, batch, *_ = reference(arch)
        lm.forward(carry(params, "cpu"), get_smoke_config(arch),
                   to_torch(batch), mode="train")
    assert [m.launches for m in (flash_attention, mamba2_ssd,
                                 slstm_cell)] == before


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, (ParamSpec, jparam.ParamSpec)):
        return [(prefix, tree)]
    return [x for k in sorted(tree) for x in _spec_leaves(tree[k],
                                                          prefix + (k,))]


def _leaves(tree, prefix=()):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [x for k in sorted(tree) for x in _leaves(tree[k], prefix + (k,))]


def _same_schema(got, want):
    g, w = _spec_leaves(got), _spec_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, gs), (_, ws) in zip(g, w):
        assert (gs.shape, gs.axes, gs.init, gs.scale) \
            == (ws.shape, ws.axes, ws.init, ws.scale), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schemas_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    _same_schema(lm.model_schema(cfg), jlm.model_schema(jcfg))
    _same_schema(lm.cache_schema(cfg, 4, 4608),
                 jlm.cache_schema(jcfg, 4, 4608))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert counting.config_param_count(cfg) \
        == jcounting.config_param_count(jcfg)
    assert [s.name for s in shapes_for(cfg)] \
        == [s.name for s in jshapes_for(jcfg)]
    for shape, jshape in zip(shapes_for(cfg), jshapes_for(jcfg)):
        assert counting.model_flops(cfg, shape) \
            == jcounting.model_flops(jcfg, jshape)
        assert counting.attention_flops(cfg, shape) \
            == jcounting.attention_flops(jcfg, jshape)


def test_init_follows_the_schema_and_the_seed():
    cfg = get_smoke_config("zamba2-7b")
    a = lm.init(torch.Generator().manual_seed(3), cfg)
    b = lm.init(torch.Generator().manual_seed(3), cfg)
    want = [(path, spec.shape) for path, spec in
            _spec_leaves(jlm.model_schema(jget_smoke("zamba2-7b")))]
    assert [(path, tuple(t.shape)) for path, t in _leaves(a)] == want
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b)))
    assert float(a["body"]["b0"]["A_log"].min()) == 1.0   # "ones"
    assert float(a["body"]["b0"]["dt_bias"].abs().max()) == 0.0
    # each stacked copy is scaled by its own fan-in (64), as vmapped
    std = float(a["body"]["b0"]["w_x"].std())
    assert 0.8 / 8 < std < 1.2 / 8
    small = init_tree(torch.Generator().manual_seed(0),
                      {"w": ParamSpec((512, 64), ("a", "b"),
                                      init="small_normal")}, "float32")
    assert 0.018 < float(small["w"].std()) < 0.022


def test_carry_keeps_bfloat16_exact():
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 7), jnp.bfloat16)
    t = carry({"x": np.asarray(x)}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(),
                          np.asarray(x.astype(jnp.float32)))


def test_attention_lowering_choices():
    params, batch, want, *_ = reference("yi-6b")
    cfg = get_smoke_config("yi-6b")
    p = carry(params, "cpu")
    a, _, _ = lm.forward(p, cfg, to_torch(batch), attn_impl="chunked_tri",
                         q_chunk=8, kv_chunk=8)
    b, _, _ = lm.forward(p, cfg, to_torch(batch), q_chunk=7, kv_chunk=5)
    assert _rel(a.numpy(), want) < REL and _rel(b.numpy(), want) < REL
    with pytest.raises(ValueError, match="attn_impl"):
        lm.forward(p, cfg, to_torch(batch), attn_impl="pallas")


@pytest.mark.parametrize("S_,chunk", [(64, 16), (48, 48)])
def test_ssd_state_plain_version_matches_reference_scan(S_, chunk):
    rng = np.random.default_rng(5)
    Bz, H, P, N = 2, 4, 8, 6
    xdt = rng.standard_normal((Bz, S_, H, P)).astype(np.float32)
    da = (-np.abs(rng.standard_normal((Bz, S_, H))) * 0.2).astype(np.float32)
    bm = rng.standard_normal((Bz, S_, 1, N)).astype(np.float32)
    cm = rng.standard_normal((Bz, S_, 1, N)).astype(np.float32)
    want_y, want_state = jssm._ssd_chunked(
        jnp.asarray(xdt), jnp.asarray(da), jnp.asarray(bm), jnp.asarray(cm),
        chunk=chunk)
    rep = lambda a: torch.from_numpy(np.repeat(a, H, axis=2))
    y, state = ops.mamba2_ssd_state(torch.from_numpy(xdt),
                                    torch.from_numpy(da), rep(bm), rep(cm),
                                    chunk=chunk)
    assert state.dtype == torch.float32 and state.shape == (Bz, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=2e-4, atol=2e-5)
    # the state pair's y is the plain version's
    assert torch.equal(y, ref.ssd_ref(torch.from_numpy(xdt),
                                      torch.from_numpy(da), rep(bm),
                                      rep(cm)))


def test_slstm_state_plain_version_matches_reference_scan():
    cfg = jget_smoke("xlstm-125m")
    H = cfg.xlstm.num_heads
    dh = cfg.d_model // H
    rng = np.random.default_rng(6)
    Bz, S_ = 2, 24
    g_in = (rng.standard_normal((Bz, S_, 4, H, dh)) * 0.5).astype(np.float32)
    p = {"r_gates": (rng.standard_normal((H, dh, 4, dh)) * 0.1
                     ).astype(np.float32),
         "b_gates": (rng.standard_normal((4, H, dh)) * 0.1
                     ).astype(np.float32)}
    zeros = jnp.zeros((Bz, H, dh), jnp.float32)
    state, hs = jax.lax.scan(
        lambda s, gi: jxlstm._slstm_cell(p, s, gi), (zeros,) * 4,
        jnp.asarray(g_in).swapaxes(0, 1))
    h, (c, n, m) = ops.slstm_cell_state(
        torch.from_numpy(g_in), torch.from_numpy(p["r_gates"]),
        torch.from_numpy(p["b_gates"]))
    np.testing.assert_allclose(h.numpy(),
                               np.asarray(hs.swapaxes(0, 1)), rtol=2e-4,
                               atol=2e-5)
    for got, want in zip((c, n, m, h[:, -1]), state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("op,args,state_elems", [
    ("mamba2_ssd", (f32(2, 64, 3, 8), f32(2, 64, 3), f32(2, 64, 3, 6),
                    f32(2, 64, 3, 6)), 2 * 3 * 8 * 6),
    ("slstm_cell", (f32(2, 12, 4, 3, 16), f32(3, 16, 4, 16), f32(4, 3, 16)),
     3 * 2 * 3 * 16)])
def test_state_ops_are_priced_by_their_cost_rules(op, args, state_elems):
    """The counter meets a prefill's state-returning wrapper as it meets
    the no-state one: a custom op priced by its cost rule (that rule plus
    the state's float32 store), never run.  On fake card tensors the op
    gives the pair's shapes and nothing launches."""
    kw = {"chunk": 16} if op == "mamba2_ssd" else {}
    base = count_fn(functools.partial(getattr(ops, op), **kw), *args)
    got = count_fn(functools.partial(getattr(ops, op + "_state"), **kw),
                   *args)
    assert {k: v - base.get(k, 0) for k, v in got.items()
            if v != base.get(k, 0)} == {
        "f_mem_contig_float32_store": state_elems,
        BYTES_OUT_FEATURE: 4 * state_elems}
    before = (mamba2_ssd.launches, slstm_cell.launches)
    with FakeTensorMode():
        y, state = getattr(ops, op + "_state")(
            *(torch.empty(t.shape, device="cuda") for t in args), **kw)
    assert (mamba2_ssd.launches, slstm_cell.launches) == before
    assert y.device.type == "cuda"
    shapes = [tuple(t.shape) for t in
              ((state,) if op == "mamba2_ssd" else state)]
    assert sum(np.prod(s_) for s_ in shapes) == state_elems


def test_models_layer_calls_kernels_through_the_ops_module(monkeypatch):
    """chip_smoke.py wraps ``ops.flash_attention`` to record the model's
    own kernel inputs: the model must call it through the module."""
    seen = []
    real = ops.flash_attention

    def spy(*a, **kw):
        seen.append(tuple(a[0].shape))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    params, batch, *_ = reference("gemma2-9b")
    lm.forward(carry(params, "cpu"), get_smoke_config("gemma2-9b"),
               to_torch(batch))
    assert len(seen) == get_smoke_config("gemma2-9b").num_layers
    assert layers.ops is ops
