"""The port's model expressions and Levenberg-Marquardt fit against the
reference's, on the same numpy tables.

Tolerances: evaluation, breakdown and Jacobians agree to rtol 1e-5 (the
reference evaluates in float32 unless x64 is on, the port in float64);
noiseless synthetic recovery is rtol 1e-5; the port's fit matches the
reference ``fit_model`` to rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import calibrate as jcal
from repro.core import model as jmodel
from repro_torch.core import calibrate as tcal
from repro_torch.core import model as tmodel
from repro_torch.profiles.presets import BASE_MODEL_EXPR, DEFAULT_OUTPUT_FEATURE

OUT = DEFAULT_OUTPUT_FEATURE
OVERLAP_EXPR = ("overlap2(p_madd * f_op_float32_madd, "
                "p_mem * (f_mem_contig_float32_load "
                "+ f_mem_contig_float32_store), p_edge) "
                "+ p_launch * f_sync_launch_kernel")
SMOOTHMAX_EXPR = ("smoothmax(p_a * f_x, p_b * f_y, p_c * f_z, p_edge) "
                  "- p_d * f_x + exp(p_e * f_y) + maximum(p_a * f_x, 1e-9)")

BASE_PARAMS = {"p_madd": 2e-12, "p_alu": 4e-12, "p_mem": 3e-11,
               "p_strided": 9e-11, "p_gather": 2e-10, "p_concat": 5e-11,
               "p_launch": 6e-6}


def _table(expr, n_rows=24, seed=0, zero_row=False):
    """Random nonnegative feature columns plus the true output of
    ``expr`` under known parameters (float64 numpy)."""
    m = tmodel.Model(OUT, expr)
    rng = np.random.default_rng(seed)
    F = rng.uniform(0, 1, (n_rows, len(m.feature_names))) \
        * 10.0 ** rng.integers(3, 8, (n_rows, len(m.feature_names)))
    launch = [i for i, n in enumerate(m.feature_names)
              if n == "f_sync_launch_kernel"]
    F[:, launch] = 1.0
    if zero_row:
        F[0, :] = 0.0
        F[0, launch] = 1.0
    return m, F


def _params(m, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for p in m.param_names:
        out[p] = 40.0 if "edge" in p else BASE_PARAMS.get(
            p, float(rng.uniform(1e-11, 1e-9)))
    return out


@pytest.mark.parametrize("expr", [BASE_MODEL_EXPR, OVERLAP_EXPR,
                                  SMOOTHMAX_EXPR])
def test_eval_and_breakdown_match_reference(expr):
    m, F = _table(expr)
    jm = jmodel.Model(OUT, expr)
    params = _params(m)
    assert m.param_names == jm.param_names
    assert m.feature_names == jm.feature_names
    assert m.breakdown_labels == jm.breakdown_labels
    assert m.signature() == jm.signature()
    p = [params[n] for n in m.param_names]
    got = m.batched_eval(torch.tensor(p, dtype=torch.float64),
                         torch.tensor(F)).numpy()
    want = np.asarray(jm.batched_eval(jnp.asarray(p), jnp.asarray(F)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    parts = m.batched_breakdown(torch.tensor(p, dtype=torch.float64),
                                torch.tensor(F)).numpy()
    jparts = np.asarray(jm.batched_breakdown(jnp.asarray(p),
                                             jnp.asarray(F)))
    np.testing.assert_allclose(parts, jparts, rtol=1e-5,
                               atol=1e-5 * np.abs(jparts).max())
    np.testing.assert_allclose(parts.sum(1), got, rtol=1e-12)


def test_param_jacobian_and_design_matrix_match_reference():
    m, F = _table(OVERLAP_EXPR)
    jm = jmodel.Model(OUT, OVERLAP_EXPR)
    p = np.array([_params(m)[n] for n in m.param_names])
    J = m.param_jacobian(p, F)
    jJ = jm.param_jacobian(jnp.asarray(p), jnp.asarray(F))
    scale = np.abs(jJ).max(axis=0)
    np.testing.assert_allclose(J / scale, jJ / scale, rtol=1e-5, atol=1e-6)

    rows = [{**dict(zip(m.feature_names, r)), OUT: 1e-3 * (i + 1),
             "_kernel": f"k{i}"} for i, r in enumerate(F)]
    Ft, tt = m.design_matrix(tmodel.FeatureTable.from_rows(rows))
    Fj, tj = jm.design_matrix(jmodel.FeatureTable.from_rows(rows))
    np.testing.assert_allclose(Ft, Fj, rtol=1e-12)
    np.testing.assert_allclose(tt, tj)


@pytest.mark.parametrize("expr", ["p_x * f_x + import_thing",
                                  "p_x.attr", "p_x[0]", "lambda: 1",
                                  "open(p_x)"])
def test_parser_rejects_what_the_reference_rejects(expr):
    for cls in (tmodel.Model, jmodel.Model):
        with pytest.raises(ValueError):
            cls(OUT, expr)


def _synthetic_rows(expr, params, seed=0, zero_row=False):
    m, F = _table(expr, seed=seed, zero_row=zero_row)
    p = torch.tensor([params[n] for n in m.param_names], dtype=torch.float64)
    y = m.batched_eval(p, torch.tensor(F)).numpy()
    return [{**dict(zip(m.feature_names, r)), OUT: float(t),
             "_kernel": f"k{i}"} for i, (r, t) in enumerate(zip(F, y))]


def test_noiseless_linear_recovery():
    m = tmodel.Model(OUT, BASE_MODEL_EXPR)
    rows = _synthetic_rows(BASE_MODEL_EXPR, BASE_PARAMS)
    fit = tcal.fit_model(m, rows, nonneg=True)
    assert fit.converged
    for n, v in BASE_PARAMS.items():
        np.testing.assert_allclose(fit.params[n], v, rtol=1e-5)
    assert fit.residual_norm < 1e-6


def test_overlap_zero_row_guard_keeps_jacobian_finite():
    """A row with both overlapped costs zero (a launch-only kernel) must
    not turn the Jacobian into NaN (the reference's overlap2 guard)."""
    params = {"p_madd": 2e-12, "p_mem": 3e-11, "p_edge": 40.0,
              "p_launch": 6e-6}
    m = tmodel.Model(OUT, OVERLAP_EXPR)
    rows = _synthetic_rows(OVERLAP_EXPR, params, zero_row=True)
    F, _ = m.design_matrix(tmodel.FeatureTable.from_rows(rows))
    p = np.array([params[n] for n in m.param_names])
    assert np.isfinite(m.param_jacobian(p, F)).all()
    fit = tcal.fit_model(m, rows, nonneg=True,
                         p0={"p_madd": 1e-12, "p_mem": 1e-11,
                             "p_launch": 1e-6})
    assert np.isfinite(list(fit.params.values())).all()
    assert fit.residual_norm < 1e-3


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_matches_reference_fit_model(seed):
    rng = np.random.default_rng(seed)
    m = tmodel.Model(OUT, BASE_MODEL_EXPR)
    rows = _synthetic_rows(BASE_MODEL_EXPR, BASE_PARAMS, seed=seed)
    # 3% multiplicative noise: the optimum is no longer the truth
    for r in rows:
        r[OUT] *= float(1 + 0.03 * rng.standard_normal())
    got = tcal.fit_model(m, rows, nonneg=True)
    want = jcal.fit_model(jmodel.Model(OUT, BASE_MODEL_EXPR), rows,
                          nonneg=True)
    for n in m.param_names:
        np.testing.assert_allclose(got.params[n], want.params[n], rtol=1e-4)
    np.testing.assert_allclose(got.residual_norm, want.residual_norm,
                               rtol=1e-4)
    rel = tcal.relative_errors(m, got.params, rows)
    jrel = jcal.relative_errors(jmodel.Model(OUT, BASE_MODEL_EXPR),
                                got.params, rows)
    np.testing.assert_allclose([rel[k] for k in sorted(rel)],
                               [jrel[k] for k in sorted(jrel)], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tcal.gmre_of(rel), jcal.gmre_of(jrel),
                               rtol=1e-4)


def test_lm_rejects_singular_steps_and_stays_finite():
    """Two parameters multiplying one feature: only their sum is fit."""
    m = tmodel.Model(OUT, "p_a * f_x + p_b * f_x")
    rows = [{"f_x": float(x), OUT: 3e-9 * x, "_kernel": f"k{x}"}
            for x in (1e3, 2e3, 5e3)]
    fit = tcal.fit_model(m, rows, nonneg=True)
    np.testing.assert_allclose(fit.params["p_a"] + fit.params["p_b"], 3e-9,
                               rtol=1e-5)


def test_feature_table_round_trip_matches_reference_json():
    rows = _synthetic_rows(BASE_MODEL_EXPR, BASE_PARAMS)
    t = tmodel.FeatureTable.from_rows(rows)
    t.row_noise = {"k0": {"median": 1.0, "std": 0.1, "min": 0.9}}
    j = jmodel.FeatureTable.from_dict(t.to_dict())
    assert j.to_dict() == t.to_dict()
    assert t.noise_summary() == j.noise_summary()
    back = tmodel.FeatureTable.from_dict(j.to_dict())
    np.testing.assert_array_equal(back.values, t.values)
