"""The port's LM multi-starts are the reference's: ``jax.random``'s
Threefry draws reproduced in numpy (``repro_torch.core.threefry``), bit
for bit, so ``fit_model(seeds=3)`` starts from the same points in both
packages and the float64 fits agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core.model import FeatureTable as JFeatureTable
from repro.core.model import Model as JModel
from repro_torch.core import calibrate as tcal
from repro_torch.core import threefry
from repro_torch.core.model import DTYPE, Model
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    KernelCollection,
    MatchCondition,
    gather_feature_table,
)
from repro_torch.profiles.presets import (
    BASE_MODEL_EXPR,
    CALIBRATION_TAGS,
    DEFAULT_OUTPUT_FEATURE,
)
from repro_torch.studies import paper_figures
from test_torch_model import CARD_BASE_TIMES
from test_torch_paper_figures import _device


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_draws_are_jax_random_bit_for_bit(dtype):
    """PRNGKey(0), one split a start and uniform(-2, 2) at 1–5 starts and
    1–9 parameters: the same keys and the same bits as jax (float32 at
    jax's default, float64 under x64)."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        key, k = jax.random.PRNGKey(0), threefry.prng_key(0)
        assert np.array_equal(np.asarray(key), np.asarray(k, np.uint32))
        for _ in range(5):
            key, sub = jax.random.split(key)
            k, ks = threefry.split(k)
            assert np.array_equal(np.asarray(key), np.asarray(k, np.uint32))
            assert np.array_equal(np.asarray(sub), np.asarray(ks, np.uint32))
            for n in range(1, 10):
                want = np.asarray(jax.random.uniform(
                    sub, (n,), minval=-2.0, maxval=2.0))
                got = threefry.uniform(ks, (n,), minval=-2.0, maxval=2.0,
                                       dtype=dtype)
                assert want.dtype == got.dtype
                assert np.array_equal(want.view(np.uint8),
                                      got.view(np.uint8)), (n, want, got)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("seeds", [1, 2, 3, 5])
def test_multi_starts_are_the_references_at_x64(x64, seeds):
    """The port's restart matrix is the reference's x64 one: the edge
    parameter pinned at 100, the others the nominal start times
    exp(uniform(-2, 2)) (exp to the last bit or so)."""
    names = ["p_a", "p_edge", "p_b", "p_c"]
    p_init = np.full(len(names), 1e-9)
    want = np.asarray(jcal._multi_starts(jnp.asarray(p_init), names, seeds))
    got = tcal._multi_starts(torch.as_tensor(p_init, dtype=DTYPE), names,
                             seeds).numpy()
    assert got.shape == want.shape == (seeds, len(names))
    np.testing.assert_allclose(got, want, rtol=1e-15)


def _fig5_table():
    model = Model(DEFAULT_OUTPUT_FEATURE, paper_figures.FIG5_MODEL_EXPR)
    return paper_figures.calibrate(
        model, paper_figures.kernels(paper_figures.FIG5_TAGS), trials=1,
        timer=_device("port", "fig5").timer, nonneg=False)[0]


def _base_table():
    kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
        CALIBRATION_TAGS, MatchCondition.INTERSECT)
    m = Model(DEFAULT_OUTPUT_FEATURE, BASE_MODEL_EXPR)
    return gather_feature_table(m.all_features(), kernels, trials=3,
                                timer=lambda k, _: CARD_BASE_TIMES[k.name])


def _fits(expr, table, nonneg):
    model = Model(DEFAULT_OUTPUT_FEATURE, expr)
    got = tcal.fit_model(model, table, nonneg=nonneg, seeds=3)
    want = jcal.fit_model(JModel(DEFAULT_OUTPUT_FEATURE, expr),
                          JFeatureTable.from_dict(table.to_dict()),
                          nonneg=nonneg, seeds=3)
    assert got.params.keys() == want.params.keys()
    F = torch.as_tensor(model.align(table), dtype=DTYPE)

    def predicted(params):
        p = torch.as_tensor([params[n] for n in model.param_names],
                            dtype=DTYPE)
        return model.batched_eval(p, F).numpy()

    return got, want, predicted(got.params), predicted(want.params)


def test_fig5_fit_with_three_starts_is_the_reference_x64_fit(x64):
    """``fit_model(seeds=3)`` on Fig 5's table: from the shared restarts
    the port's float64 fit and the reference's x64 fit reach one residual
    (a better one than the nominal start alone), the same rates and the
    same prediction on every row, each to rtol 1e-4.  ``p_edge`` is held
    through the predictions only: past the edge ``overlap2`` is a sharp
    max whatever its value (the two fits stop at 1.4e3 and 9.2e8)."""
    got, want, pred_got, pred_want = _fits(
        paper_figures.FIG5_MODEL_EXPR, _fig5_table(), nonneg=False)
    np.testing.assert_allclose(got.residual_norm, want.residual_norm,
                               rtol=1e-4)
    for name in ("p_g", "p_c", "p_launch"):
        np.testing.assert_allclose(got.params[name], want.params[name],
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(pred_got, pred_want, rtol=1e-4)


def test_base_fit_with_three_starts_is_the_reference_x64_fit(x64):
    """``fit_model(seeds=3)`` on the card's 43-row base table: one
    residual to rtol 1e-4.  The x64 reference accepts any float64
    decrease and is still creeping along the base model's flat valley at
    its 200-iteration cap, where the port (float32-resolution acceptance)
    converges, so the rates agree to 5e-3 and the predictions to 1e-3,
    as against the reference's float32 fit
    (``test_torch_model.py::test_base_fit_on_the_card_table_converges_as_the_reference``)."""
    got, want, pred_got, pred_want = _fits(BASE_MODEL_EXPR, _base_table(),
                                           nonneg=True)
    assert got.converged
    np.testing.assert_allclose(got.residual_norm, want.residual_norm,
                               rtol=1e-4)
    for name, value in got.params.items():
        np.testing.assert_allclose(value, want.params[name], rtol=5e-3,
                                   err_msg=name)
    np.testing.assert_allclose(pred_got, pred_want, rtol=1e-3)
