"""Training the port's language models on the CPU, against the reference.

For every smoke architecture, with the reference's weights carried leaf
for leaf (``models.param.carry``): ``lm_loss`` within 1e-5 and every
gradient leaf within 1e-4 × its max |g| of ``jax.value_and_grad`` of the
reference's ``lm_loss``.  ``remat`` none / full / dots give the same loss
and gradients (the reference's ``test_remat_matches_no_remat``).  Three
steps of ``make_train_step`` with 2 microbatches against the reference's.
The SSD's and the sLSTM's host gradients against the vjp of the
reference's ``_ssd_chunked`` and sLSTM scan.  The other five
architectures, attention's gradient and the counter's pricing of it:
``tests/test_torch_train_grads.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape, OptimizerConfig, RunConfig
from repro_torch.kernels import flash_attention, ops
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.param import carry, tree_leaves, tree_map
from repro_torch.optim import adamw

LOSS_REL = 1e-5
GRAD_REL = 1e-4
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


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def np_leaves(tree):
    """A reference tree's leaves in its own (sorted-key) order, as numpy,
    with the path of each."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(("/".join(str(p.key) for p in path), np.asarray(leaf)))
    return out


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's smoke params (numpy), batch, loss and gradients."""
    cfg = jget_smoke(arch)
    params = jlm.init(jax.random.PRNGKey(0), cfg)
    batch = make_batch(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, cfg, b)[0]))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            np_leaves(grads))


def port_grads(params, cfg, batch, remat="full"):
    params = tree_map(lambda t: t.requires_grad_(), params)
    loss_fn = functools.partial(lm.lm_loss, cfg=cfg, remat=remat)
    loss, _, grads = steps.value_and_grad(
        lambda p, b: loss_fn(p, batch=b), params, batch)
    return float(loss), grads


def assert_grads_close(grads, want, rel=GRAD_REL):
    for path, w in want:
        g = leaf(grads, path).detach().double().numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w.astype(np.float64)).max()) / scale
        assert err <= rel, (path, err)


#: the architectures of this file's gradient test; the rest are in
#: tests/test_torch_train_grads.py (two files, so xdist runs them apart)
ARCHS_HERE = ("zamba2-7b", "xlstm-125m", "gemma2-9b", "yi-6b", "granite-8b")


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_and_every_gradient_match_reference(arch):
    params, batch, want_loss, want = reference(arch)
    cfg = get_smoke_config(arch)
    loss, grads = port_grads(carry(params, "cpu"), cfg, to_torch(batch))
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_REL)
    assert len(tree_leaves(grads)) == len(want)
    assert_grads_close(grads, want)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b", "xlstm-125m"])
def test_remat_policies_agree(arch):
    """none, full and dots recompute the same arithmetic: the same loss
    and gradients, and a host run launches no kernel."""
    params, batch, _, _ = reference(arch)
    cfg = get_smoke_config(arch)
    before = (flash_attention.launches, flash_attention.backward_launches)
    runs = {r: port_grads(carry(params, "cpu"), cfg, to_torch(batch), r)
            for r in ("none", "full", "dots")}
    assert (flash_attention.launches,
            flash_attention.backward_launches) == before
    base_loss, base = runs["none"]
    for r in ("full", "dots"):
        loss, grads = runs[r]
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
        for a, b in zip(tree_leaves(grads), tree_leaves(base)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        lm.forward(carry(params, "cpu"), cfg, to_torch(batch),
                   remat="everything")


def test_train_step_with_microbatches_matches_reference():
    """Three steps of make_train_step with 2 microbatches (gradients
    accumulated in the parameter dtype) from the same weights and
    batches: loss and every metric within 1e-5 at each step (the losses
    of steps 2 and 3 are those of the updated parameters)."""
    arch = "gemma2-9b"
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    okw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jrun = JRunConfig(model=jcfg, shape=JInputShape("t", S, 4, "train"),
                      optimizer=JOptimizerConfig(**okw), microbatches=2)
    run = RunConfig(model=cfg, shape=InputShape("t", S, 4, "train"),
                    optimizer=OptimizerConfig(**okw), microbatches=2)
    jparams = jlm.init(jax.random.PRNGKey(1), jcfg)
    params = tree_map(lambda t: t.requires_grad_(),
                      carry(jax.tree.map(np.asarray, jparams), "cpu"))
    jopt = jadamw.init_opt_state(jparams, jrun.optimizer)
    opt = adamw.init_opt_state(params, run.optimizer)
    jstep = jax.jit(jmake_train_step(jrun))
    step = steps.make_train_step(run)
    for i in range(3):
        batch = make_batch(cfg, seed=10 + i, b=4)
        jparams, jopt, jm = jstep(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = step(params, opt, to_torch(batch))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_REL, err_msg=k)


# ---------------------------------------------------------------------------
# the model-layer wrappers' gradients
# ---------------------------------------------------------------------------


def _rn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (48, 48)])
def test_ssd_gradient_matches_reference_scan(S_, chunk):
    """``ops.mamba2_ssd``'s host gradient (the plain recurrence's vjp)
    against the vjp of the reference's ``_ssd_chunked`` (B and C per
    group there, repeated to heads in the port)."""
    rng = np.random.default_rng(7)
    Bz, H, P, N = 2, 4, 8, 6
    xdt = _rn(rng, Bz, S_, H, P)
    da = (-np.abs(rng.standard_normal((Bz, S_, H))) * 0.2).astype(np.float32)
    bm, cm = _rn(rng, Bz, S_, 1, N), _rn(rng, Bz, S_, 1, N)
    dy = _rn(rng, Bz, S_, H, P)

    def jloss(xdt, da, bm, cm):
        y, _ = jssm._ssd_chunked(xdt, da, bm, cm, chunk=chunk)
        return jnp.sum(y * dy)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(xdt, da, bm, cm)
    x_t, da_t, b_t, c_t = (torch.from_numpy(a).requires_grad_()
                           for a in (xdt, da, bm, cm))
    y = ops.mamba2_ssd(x_t, da_t, b_t.repeat_interleave(H, dim=2),
                       c_t.repeat_interleave(H, dim=2), chunk=chunk)
    got = torch.autograd.grad(y, (x_t, da_t, b_t, c_t),
                              torch.from_numpy(dy))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()


def test_slstm_gradient_matches_reference_scan():
    """``ops.slstm_cell``'s host gradient (the plain loop's vjp) against
    the vjp of the reference's sLSTM scan, for the gate inputs and both
    recurrent parameters."""
    cfg = jget_smoke("xlstm-125m")
    H = cfg.xlstm.num_heads
    dh = cfg.d_model // H
    rng = np.random.default_rng(8)
    Bz, S_ = 2, 16
    g_in = _rn(rng, Bz, S_, 4, H, dh, scale=0.5)
    r = _rn(rng, H, dh, 4, dh, scale=0.1)
    bias = _rn(rng, 4, H, dh, scale=0.1)
    dh_out = _rn(rng, Bz, S_, H, dh)

    def jloss(g_in, r, bias):
        zeros = jnp.zeros((Bz, H, dh), jnp.float32)
        _, hs = jax.lax.scan(
            lambda s, gi: jxlstm._slstm_cell(
                {"r_gates": r, "b_gates": bias}, s, gi),
            (zeros,) * 4, g_in.swapaxes(0, 1))
        return jnp.sum(hs.swapaxes(0, 1) * dh_out)
    want = jax.grad(jloss, argnums=(0, 1, 2))(g_in, r, bias)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (g_in, r, bias)]
    h = ops.slstm_cell(*leaves)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh_out))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()
