"""Training the port's language models on the CPU, against the reference
(the second half of ``tests/test_torch_train_models.py``, apart so that
xdist runs the two at once).

The other five smoke architectures: ``lm_loss`` within 1e-5 and every
gradient leaf within 1e-4 × its max |g| of ``jax.value_and_grad`` of the
reference's, weights carried.  Attention's host gradient (the custom
op's autograd: the plain vjp) against ``jax.grad`` of the reference's
``blockwise_attention`` at ``tests/test_kernels.py``'s options and
shapes; on fake tensors the counter prices a training step's attention
backward by its cost rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import layers as jlayers
from repro_torch.analysis.targets import f32
from repro_torch.configs import get_smoke_config
from repro_torch.core.counting import count_fn
from repro_torch.kernels import flash_attention, ops
from repro_torch.models.param import carry, tree_leaves
from test_torch_train_models import (ARCHS_HERE, GRAD_REL, LOSS_REL, _rn,
                                     assert_grads_close, port_grads,
                                     reference, to_torch)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in ARCHS_HERE])
def test_loss_and_every_gradient_match_reference(arch):
    params, batch, want_loss, want = reference(arch)
    cfg = get_smoke_config(arch)
    loss, grads = port_grads(carry(params, "cpu"), cfg, to_torch(batch))
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_REL)
    assert len(tree_leaves(grads)) == len(want)
    assert_grads_close(grads, want)


def test_the_two_files_cover_every_architecture():
    assert set(ARCHS_HERE) < set(ARCH_IDS)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=64),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=32, softcap=50.0),
])
@pytest.mark.parametrize("Bz,S_,Hq,Hkv,D", [
    (2, 256, 8, 2, 64),    # GQA 4:1
    (1, 128, 4, 4, 128),   # MHA
    (2, 512, 8, 1, 64),    # MQA
])
def test_attention_gradient_matches_reference(kw, Bz, S_, Hq, Hkv, D):
    """``ops.flash_attention``'s host gradient (its custom op's autograd,
    the plain vjp) against ``jax.grad`` of the reference's
    ``blockwise_attention``, f32, within 1e-4 × max |g|."""
    rng = np.random.default_rng(S_ + D)
    q, k, v = (_rn(rng, Bz, S_, h, D) for h in (Hq, Hkv, Hkv))
    dout = _rn(rng, Bz, S_, Hq, D)

    def jloss(q, k, v):
        o = jlayers.blockwise_attention(q, k, v, q_chunk=64, kv_chunk=64,
                                        **kw)
        return jnp.sum(o * dout)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, block_q=64, block_k=64, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()


def test_counter_prices_the_attention_backward_by_its_cost_rule():
    """A training step's attention on fake tensors: the forward and the
    backward custom ops meet their cost rules, nothing runs or launches;
    the backward's needed work is 2.5× the forward's products at D = Dv."""
    def fwd(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, softcap=50.0)

    def fwd_bwd(q, k, v):
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = fwd(*leaves)
        return torch.autograd.grad(out, leaves, torch.ones_like(out))

    args = (f32(1, 128, 4, 64), f32(1, 128, 2, 64), f32(1, 128, 2, 64))
    before = (flash_attention.launches, flash_attention.backward_launches)
    one = count_fn(fwd, *args)
    both = count_fn(fwd_bwd, *args)
    assert (flash_attention.launches,
            flash_attention.backward_launches) == before
    tile_madds = one["f_op_float32_madd"] / (64 + 64)
    # forward (D + Dv), backward (3·D + 2·Dv + 1: Δ's P∘dP)
    assert both["f_op_float32_madd"] == tile_madds * (128 + 5 * 64 + 1)
    assert both["f_mem_contig_float32_store"] > one[
        "f_mem_contig_float32_store"]
