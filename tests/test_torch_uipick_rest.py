"""The five UIPiCK generators ported last (``onchip_pattern``,
``sync_loop_pattern``, ``overlap_pattern``, ``dg_diff``, ``finite_diff``)
against the reference, on the CPU.

Held to: the reference's generator list (order, names, tags, argument
spaces) and kernel names; each new variant's eager output on the
reference's inputs at the f32 tolerance of ``tests/test_kernels.py``;
counting the largest overlap kernel in one loop step's time; and every
scope hint of ``api/errors.py`` selecting kernels the port can build.
Their counts are held in ``tests/test_torch_counting.py``.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import uipick as juipick
from repro_torch.api.errors import _FEATURE_CLASS_TAGS, suggest_calibration_tags
from repro_torch.core import uipick as tuipick

NEW = ("onchip_pattern", "sync_loop_pattern", "overlap_pattern", "dg_diff",
       "finite_diff")
F32_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_kernels.py:17


def _kernels(mod, generator):
    gen = {g.name: g for g in mod.ALL_GENERATORS}[generator]
    return mod.KernelCollection([gen]).generate_kernels([])


def test_all_generators_equal_the_reference():
    ref = juipick.ALL_GENERATORS
    port = tuipick.ALL_GENERATORS
    assert [g.name for g in port] == [g.name for g in ref]
    for t, j in zip(port, ref):
        assert (t.gen_tags, t.arg_space) == (j.gen_tags, j.arg_space)
    assert not set(NEW) - {g.name for g in port}


@pytest.mark.parametrize("generator", NEW)
def test_kernel_names_and_tags_equal_the_reference(generator):
    port = _kernels(tuipick, generator)
    ref = _kernels(juipick, generator)
    assert [k.name for k in port] == [k.name for k in ref]
    assert [(k.tags, k.sizes) for k in port] == \
        [(k.tags, k.sizes) for k in ref]


SMALLEST = [
    "onchip_w2048_i64_float32",
    "loopstep_s64",
    "overlap_n4194304_m16_float32",
    "dg_basic_k8192_n64_m3_float32",
    "dg_u_pf_k8192_n64_m3_float32",
    "dg_dmat_pf_k8192_n64_m3_float32",
    "dg_dmat_pf_T_k8192_n64_m3_float32",
    "stencil_roll_n1024_float32",
    "stencil_slice_n1024_float32",
]


def _by_name(mod, name):
    kerns = mod.KernelCollection(mod.ALL_GENERATORS).generate_kernels(
        list(NEW), mod.MatchCondition.INTERSECT)
    return {k.name: k for k in kerns}[name]


@pytest.mark.parametrize("name", SMALLEST)
def test_eager_output_equals_the_reference(name):
    port = _by_name(tuipick, name)
    args = port.make_args("cpu")
    got = port.fn(*args).numpy()
    ref = _by_name(juipick, name)
    want = np.asarray(jax.jit(ref.fn)(*[jnp.asarray(a.numpy())
                                        for a in args]))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_counting_the_longest_loop_costs_one_step():
    # the process's first count pays the fake-tensor machinery's set-up
    _by_name(tuipick, "overlap_n16777216_m16_float32").counts()
    k = _by_name(tuipick, "overlap_n16777216_m65536_float32")
    t0 = time.perf_counter()
    c = k.counts()
    assert time.perf_counter() - t0 < 2.0
    assert c["f_sync_loop_steps"] == 65536
    assert c["f_op_float32_mul"] == 65536 * 1024


# one feature of each class the scope hints name
HINTED = ["f_op_float32_madd", "f_op_float32_transc", "f_op_float32_add",
          "f_mem_contig_float32_load", "f_mem_strided_float32_load",
          "f_mem_gather_float32_load", "f_mem_concat_float32_store",
          "f_mem_scatter_float32_store", "f_sync_launch_kernel",
          "f_sync_loop_steps"]


def test_the_hinted_features_cover_every_hint():
    assert sorted(tuple(suggest_calibration_tags(f)) for f in HINTED) == \
        sorted(tuple(tags) for _, _, tags in _FEATURE_CLASS_TAGS)


@pytest.mark.parametrize("feature", HINTED)
def test_every_scope_hint_selects_kernels(feature):
    """A hint's tags go to ``calibrate --tags``, whose default match is
    INTERSECT (``["matmul_sq", "flops_dot_pattern"]`` names two
    generators, so no single one is a superset of it)."""
    tags = suggest_calibration_tags(feature)
    assert tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
        .generate_kernels(tags, tuipick.MatchCondition.INTERSECT)
