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


# The 43-kernel base battery's median seconds on an NVIDIA H100 80GB HBM3
# (700.00 W), 3 trials, one CUDA-graph replay each (chip_smoke.py phase 3)
CARD_BASE_TIMES = {
    "madd_n65536_i64_float32": 0.001814079999923706,
    "madd_n65536_i256_float32": 0.007157408237457276,
    "madd_n65536_i512_float32": 0.012798399925231935,
    "dotflops_n128_i64_float32": 0.00039132800698280336,
    "dotflops_n256_i64_float32": 0.0005279679894447327,
    "dotflops_n384_i64_float32": 0.0006991680264472962,
    "stream_contig_n1048576_a1_float32": 1.6416000202298166e-05,
    "stream_strided_n1048576_a1_float32": 1.6256000846624374e-05,
    "stream_gather_n1048576_a1_float32": 1.836800016462803e-05,
    "stream_shift_n1048576_a1_float32": 1.91040001809597e-05,
    "stream_contig_n4194304_a1_float32": 1.0528000071644782e-05,
    "stream_strided_n4194304_a1_float32": 4.24639992415905e-05,
    "stream_gather_n4194304_a1_float32": 4.905600100755692e-05,
    "stream_shift_n4194304_a1_float32": 2.6528000831604006e-05,
    "stream_contig_n16777216_a1_float32": 1.2000000104308128e-05,
    "stream_strided_n16777216_a1_float32": 0.00014895999431610108,
    "stream_gather_n16777216_a1_float32": 0.0004171839952468872,
    "stream_shift_n16777216_a1_float32": 8.963199704885482e-05,
    "stream_contig_n1048576_a2_float32": 1.9168000668287278e-05,
    "stream_strided_n1048576_a2_float32": 2.3231999948620798e-05,
    "stream_gather_n1048576_a2_float32": 3.8047999143600466e-05,
    "stream_shift_n1048576_a2_float32": 2.2975999861955644e-05,
    "stream_contig_n4194304_a2_float32": 2.473600022494793e-05,
    "stream_strided_n4194304_a2_float32": 6.150399893522262e-05,
    "stream_gather_n4194304_a2_float32": 0.00011711999773979187,
    "stream_shift_n4194304_a2_float32": 6.681600213050842e-05,
    "stream_contig_n16777216_a2_float32": 7.462400197982788e-05,
    "stream_strided_n16777216_a2_float32": 0.00021241599321365358,
    "stream_gather_n16777216_a2_float32": 0.0009021120071411133,
    "stream_shift_n16777216_a2_float32": 0.0002383359968662262,
    "stream_contig_n1048576_a4_float32": 2.2143999114632608e-05,
    "stream_strided_n1048576_a4_float32": 2.4960000067949296e-05,
    "stream_gather_n1048576_a4_float32": 7.158400118350983e-05,
    "stream_shift_n1048576_a4_float32": 4.0063999593257904e-05,
    "stream_contig_n4194304_a4_float32": 5.3727999329566956e-05,
    "stream_strided_n4194304_a4_float32": 9.001599997282028e-05,
    "stream_gather_n4194304_a4_float32": 0.00024393600225448608,
    "stream_shift_n4194304_a4_float32": 0.0001387840062379837,
    "stream_contig_n16777216_a4_float32": 0.00021084800362586976,
    "stream_strided_n16777216_a4_float32": 0.0003484480082988739,
    "stream_gather_n16777216_a4_float32": 0.0018561919927597046,
    "stream_shift_n16777216_a4_float32": 0.0005360000133514404,
    "empty_n65536": 1.648000068962574e-05,
}


def test_base_fit_on_the_card_table_converges_as_the_reference():
    """On the card's own base table the reference's float32 solve stops
    after 133 iterations, converged; a float64 solve that accepts any
    decrease creeps on by ~1e-9 of the cost a step along a flat valley
    and is still going at 200.  The port judges a decrease at the
    reference's float32 resolution, so both converge at one residual.
    The rates agree to 5e-3: within 1e-5 of each other's cost they are
    free along that valley.  ``p_concat`` is not compared: no battery
    kernel has a concat feature, so any value fits.  The residual itself
    is the data's: the base model is linear in its rates, and the best
    nonnegative rates (NNLS) leave the same residual."""
    from scipy.optimize import nnls
    from repro_torch.core.uipick import (
        ALL_GENERATORS, KernelCollection, MatchCondition,
        gather_feature_table)
    from repro_torch.profiles.presets import CALIBRATION_TAGS
    kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
        CALIBRATION_TAGS, MatchCondition.INTERSECT)
    assert [k.name for k in kernels] == list(CARD_BASE_TIMES)
    m = tmodel.Model(OUT, BASE_MODEL_EXPR)
    table = gather_feature_table(m.all_features(), kernels, trials=3,
                                 timer=lambda k, _: CARD_BASE_TIMES[k.name])
    got = tcal.fit_model(m, table, nonneg=True)
    want = jcal.fit_model(jmodel.Model(OUT, BASE_MODEL_EXPR),
                          jmodel.FeatureTable.from_dict(table.to_dict()),
                          nonneg=True)
    assert want.converged and got.converged
    assert got.iterations < 200
    np.testing.assert_allclose(got.residual_norm, want.residual_norm,
                               rtol=1e-5)
    F, target = m.design_matrix(table)
    design = m.param_jacobian(np.ones(len(m.param_names)), F)
    scale = np.where(design.any(0), np.abs(design).max(0), 1.0)
    best = nnls(design / scale, target)[1]
    assert best <= got.residual_norm <= best * (1 + 1e-5)
    for n in m.param_names:
        if n != "p_concat":
            np.testing.assert_allclose(got.params[n], want.params[n],
                                       rtol=5e-3, err_msg=n)
