"""The port's MoE dispatch (``repro_torch.models.moe``) against
``tests/test_moe.py``'s five scatter cases and the reference's
``apply_moe`` (y and both aux values), with the reference's expert
weights carried over; top-k's tie order against ``lax.top_k``; the
all-to-all dispatch falls back to the scatter without a mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jmoe
from repro.models.param import init_tree as jinit_tree
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, lm, moe
from repro_torch.models.param import carry


def _setup(cf=4.0, E=8, k=2, arch="arctic-480b"):
    """tests/test_moe.py's setup, for both packages, the reference's
    weights carried into the port."""
    jcfg = jget_smoke(arch)
    jcfg = jcfg.replace(moe=jcfg.moe.replace(capacity_factor=cf,
                                             num_experts=E, top_k=k))
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(moe=cfg.moe.replace(capacity_factor=cf, num_experts=E,
                                          top_k=k))
    jp = jinit_tree(jax.random.PRNGKey(0), jmoe.moe_schema(jcfg),
                    jnp.float32)
    return cfg, jcfg, carry(jax.tree.map(np.asarray, jp), "cpu"), jp


def _x(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _both(cfg, jcfg, p, jp, x):
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    return y, aux, np.asarray(jy), jaux


def _match(y, aux, jy, jaux):
    scale = np.max(np.abs(jy)) + 1e-6
    assert np.max(np.abs(y.numpy() - jy)) < 1e-4 * scale
    for key in ("moe_aux_loss", "moe_frac_dropped"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-5, atol=1e-7)


def test_moe_output_finite_and_shaped():
    cfg, jcfg, p, jp = _setup()
    x = _x(1, (2, 16, cfg.d_model))
    y, aux, jy, jaux = _both(cfg, jcfg, p, jp, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["moe_aux_loss"]) > 0
    _match(y, aux, jy, jaux)


def test_no_drops_with_ample_capacity():
    cfg, jcfg, p, jp = _setup(cf=8.0)
    x = _x(2, (2, 32, cfg.d_model))
    y, aux, jy, jaux = _both(cfg, jcfg, p, jp, x)
    assert float(aux["moe_frac_dropped"]) == 0.0
    _match(y, aux, jy, jaux)


def test_drops_with_tiny_capacity():
    cfg, jcfg, p, jp = _setup(cf=0.1)
    x = _x(3, (2, 64, cfg.d_model))
    y, aux, jy, jaux = _both(cfg, jcfg, p, jp, x)
    assert float(aux["moe_frac_dropped"]) > 0.2
    # the same tokens are dropped: ranks follow the stable sort
    _match(y, aux, jy, jaux)


def test_capacity_formula_monotone():
    cfg, jcfg, _, _ = _setup()
    caps = [moe._capacity(t, cfg.moe) for t in (64, 256, 1024)]
    assert caps == sorted(caps)
    assert all(c % 8 == 0 for c in caps)
    assert caps == [jmoe._capacity(t, jcfg.moe) for t in (64, 256, 1024)]


def test_moe_gradients_flow_to_experts():
    cfg, jcfg, p, jp = _setup()
    x = torch.from_numpy(_x(4, (1, 16, cfg.d_model)))
    for t in (p["w_up"], p["router"]):
        t.requires_grad_(True)
    y, aux = moe.apply_moe(p, cfg, x)
    (torch.sum(y ** 2) + aux["moe_aux_loss"]).backward()
    assert float(p["w_up"].grad.abs().sum()) > 0
    assert float(p["router"].grad.abs().sum()) > 0

    def loss(jp):
        y, aux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x.numpy()))
        return jnp.sum(y ** 2) + aux["moe_aux_loss"]
    g = jax.grad(loss)(jp)
    for name in ("w_up", "router"):
        want = np.asarray(g[name])
        np.testing.assert_allclose(p[name].grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.max(np.abs(want)))


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_apply_moe_matches_reference(arch):
    """The smoke configs as they are: the dense residual (arctic) and the
    shared experts (deepseek) too."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jp = jinit_tree(jax.random.PRNGKey(7), jmoe.moe_schema(jcfg),
                    jnp.float32)
    p = carry(jax.tree.map(np.asarray, jp), "cpu")
    _match(*_both(cfg, jcfg, p, jp, _x(5, (2, 24, cfg.d_model))))


def test_top_k_breaks_ties_as_lax_top_k():
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2],
                     [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe.top_k(torch.from_numpy(rows), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(rows), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_a2a_dispatch_raises_until_the_mesh_is_ported():
    """``moe_impl="a2a"`` dispatches to ``models.moe_a2a``; without a
    mesh (no "model" axis) it is the reference's fallback to the
    scatter, so the layer and the whole model give the scatter's results
    bit for bit.  The all-to-all itself at 8 ranks:
    ``tests/test_torch_mesh.py``."""
    cfg = get_smoke_config("deepseek-v2-236b")
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    layer = jax.tree.map(lambda t: t[0], params["body"])["b0"]
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    got = {}
    for impl in ("scatter", "a2a"):
        ctx = layers.Ctx(cfg=cfg, mode="train",
                         positions=torch.arange(4)[None], moe_impl=impl)
        y, _, aux = moe.apply_moe_layer(layer, x, ctx)
        logits, _, _ = lm.forward(params, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.long)}, moe_impl=impl)
        got[impl] = (y, aux["moe_aux_loss"], logits)
    for a, b in zip(got["scatter"], got["a2a"]):
        assert torch.equal(a, b)
