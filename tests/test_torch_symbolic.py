"""Symbolic counts in the port: ``repro_torch.core.symbolic`` (its own copy
of the reference's polynomial CAS) and ``SymbolicCounts`` /
``parametric_counts`` in ``repro_torch.core.counting`` — the cases of
the reference's ``tests/test_countengine.py`` on ``Poly.eval_batch`` and
``parametric_counts``, each also held against the reference on the same
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import symbolic as jsym
from repro.core.counting import parametric_counts as jparametric_counts
from repro_torch.core import symbolic as tsym
from repro_torch.core.counting import (
    FeatureCounts,
    counted_loop,
    parametric_counts,
    parametric_counts_from,
)
from repro_torch.core.symbolic import Poly, interpolate_polynomial


def _poly(mod, coeffs):
    n = mod.Poly.var("n")
    p = mod.Poly.const(0)
    for i, c in enumerate(coeffs):
        p = p + mod.Poly.const(c) * n ** i
    return p


# ---------------------------------------------------------------------------
# Poly.eval_batch ≡ scalar evaluation (and ≡ the reference's)
# ---------------------------------------------------------------------------


@given(st.lists(st.integers(-7, 7), min_size=1, max_size=6),
       st.lists(st.integers(0, 50), min_size=1, max_size=8))
@settings(max_examples=40, deadline=None)
def test_eval_batch_matches_scalar_univariate(coeffs, grid):
    p = _poly(tsym, coeffs)
    batch = p.eval_batch(n=np.asarray(grid, np.float64))
    assert batch.shape == (len(grid),)
    for x, v in zip(grid, batch):
        assert v == p(n=x)
    ref = _poly(jsym, coeffs).eval_batch(n=np.asarray(grid, np.float64))
    np.testing.assert_array_equal(batch, ref)
    assert repr(p) == repr(_poly(jsym, coeffs))


@given(st.lists(st.integers(1, 40), min_size=1, max_size=6),
       st.lists(st.integers(1, 40), min_size=1, max_size=6),
       st.integers(-5, 5), st.integers(-5, 5), st.integers(-5, 5))
@settings(max_examples=30, deadline=None)
def test_eval_batch_matches_scalar_multivariate(xs, ys, a, b, c):
    k = min(len(xs), len(ys))
    xs, ys = xs[:k], ys[:k]
    x, y = Poly.var("x"), Poly.var("y")
    p = Poly.const(a) * x ** 2 * y + Poly.const(b) * y ** 3 + Poly.const(c)
    batch = p.eval_batch(x=np.asarray(xs, np.float64),
                         y=np.asarray(ys, np.float64))
    for xi, yi, v in zip(xs, ys, batch):
        assert v == p(x=xi, y=yi)


def test_eval_batch_edge_cases():
    zero = Poly()
    assert zero.eval_batch().shape == ()
    const = Poly.const(7)
    assert float(const.eval_batch()) == 7.0
    p = Poly.var("n") + 1
    with pytest.raises(ValueError, match="unbound"):
        p.eval_batch()
    # broadcasting: scalar env value against the polynomial
    assert float(p.eval_batch(n=41)) == 42.0


@pytest.mark.parametrize("degrees", [{"n": 0}, {"n": 3}, {"n": 2, "m": 1},
                                     {"a": 1, "b": 1, "c": 2}])
def test_interpolation_is_the_references(degrees):
    """The same probe function reconstructs the same polynomial (terms and
    Fraction coefficients) in both packages."""
    def f(**s):
        v = 3
        for i, (name, d) in enumerate(sorted(degrees.items())):
            v += (i + 2) * s[name] ** d + s[name] // 16
        return v

    got = interpolate_polynomial(f, degrees)
    want = jsym.interpolate_polynomial(f, degrees)
    assert got.terms == want.terms


# ---------------------------------------------------------------------------
# parametric_counts regressions
# ---------------------------------------------------------------------------


def test_parametric_counts_degree0_var_and_feature_absent_at_base():
    """A degree-0 size variable rides along un-probed, and a feature that
    is zero at the base probe size but nonzero at larger grid sizes must
    still reconstruct its polynomial exactly — in the port, through
    ``counted_loop``; in the reference, through ``scan``."""
    def fn(x):
        n = x.shape[0]
        if n <= 16:                # base probe size: no loop at all
            return x + 1.0
        c = counted_loop(n // 16 - 1, lambda i, c: torch.tanh(c), x)
        return c + 1.0

    sym = parametric_counts(
        lambda n, m: (torch.empty((n,), device="meta"),), fn,
        {"n": 2, "m": 0})
    assert "f_op_float32_transc" in sym.counts
    assert sym.at(n=16, m=16)["f_op_float32_transc"] == 0
    assert sym.at(n=64, m=16)["f_op_float32_transc"] == 64 * 3
    assert sym.at(n=160, m=16)["f_op_float32_transc"] == 160 * 9
    assert sym.at(n=64, m=99)["f_op_float32_add"] == \
        sym.at(n=64, m=16)["f_op_float32_add"] == 64
    batch = sym.at_batch(n=np.array([16., 64., 96.]),
                         m=np.array([1., 1., 1.]))
    np.testing.assert_allclose(batch["f_op_float32_transc"],
                               [0, 192, 480])
    np.testing.assert_allclose(batch["f_op_float32_add"], [16, 64, 96])

    def jfn(x):
        n = x.shape[0]
        if n <= 16:
            return x + 1.0
        c, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c), None), x, None,
                            length=n // 16 - 1)
        return c + 1.0

    jsym_counts = jparametric_counts(
        lambda n, m: (jnp.zeros((n,)),), jfn, {"n": 2, "m": 0})
    for fid in ("f_op_float32_transc", "f_op_float32_add"):
        assert sym.counts[fid].poly.terms == \
            jsym_counts.counts[fid].poly.terms, fid


def test_parametric_counts_probe_each_grid_point_once():
    calls = []

    def probe(**sizes):
        calls.append(tuple(sorted(sizes.items())))
        fc = FeatureCounts()
        fc.add("f_x", sizes["n"] ** 2 * sizes["m"])
        return fc

    sym = parametric_counts_from(probe, {"n": 2, "m": 1}, base=8, scale=8)
    assert sorted(calls) == sorted(set(calls)) and len(calls) == 3 * 2
    assert sym.at(n=40, m=24)["f_x"] == 40 ** 2 * 24
    assert sym.assumptions == ("n % 8 == 0", "m % 8 == 0")
