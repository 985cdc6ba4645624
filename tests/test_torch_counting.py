"""The port's counter and cost rules.

* Hand-kernel cost rules equal the closed forms of
  ``tests/test_pallascost.py`` exactly (and the DG operator's, derived by
  the same block-traffic rule), priced through ``count_fn`` on ``meta``
  tensors — nothing runs.
* The aten-level walker counts each UIPiCK generator's smallest variant
  (all ten generators) as the reference's jaxpr walker does, up to the
  pinned differences listed in ROADMAP queue C.
* ``counted_loop`` counts one step times the trip count, as a
  ``counted_range`` loop counts every step.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import uipick as juipick
from repro_torch.analysis.kernelcost import (
    BYTES_IN_FEATURE,
    BYTES_OUT_FEATURE,
    block_fetches,
)
from repro_torch.analysis.targets import f32
from repro_torch.core import uipick as tuipick
from repro_torch.core.counting import count_fn, counted_loop, counted_range
from repro_torch.kernels import dg_diff as tdg
from repro_torch.kernels import matmul_tiled as tmm
from repro_torch.kernels import ops
from repro_torch.kernels import stencil5 as tst


@pytest.mark.parametrize("M,N,K,b", [
    (256, 384, 512, 128),
    (128, 128, 128, 128),
    (512, 256, 128, 64),
])
def test_matmul_cost_rule_matches_closed_form(M, N, K, b):
    fn = functools.partial(ops.matmul, block_m=b, block_n=b, block_k=b)
    c = count_fn(fn, f32(M, K), f32(K, N))
    gm, gn, gk = M // b, N // b, K // b
    assert c["f_op_float32_madd"] == M * N * K
    assert c[BYTES_IN_FEATURE] == 4 * gm * gn * gk * (b * b + b * b)
    assert c[BYTES_OUT_FEATURE] == 4 * M * N
    assert c["f_mem_contig_float32_load"] == 2 * gm * gn * gk * b * b
    assert c["f_sync_grid_programs"] == gm * gn * gk
    assert c["f_sync_launch_kernel"] == 1


@pytest.mark.parametrize("M,N,bm,bn", [
    (256, 512, 128, 128),
    (256, 256, 128, 128),
    (512, 512, 256, 128),
])
def test_stencil5_cost_rule_matches_closed_form(M, N, bm, bn):
    fn = functools.partial(ops.stencil5, block_m=bm, block_n=bn)
    c = count_fn(fn, f32(M, N))
    gm, gn = M // bm, N // bn
    assert c[BYTES_IN_FEATURE] == 4 * gm * gn * (bm + 2) * (bn + 2)
    assert c[BYTES_OUT_FEATURE] == 4 * M * N
    assert c["f_op_float32_add"] == 4 * M * N
    assert c["f_op_float32_mul"] == M * N


@pytest.mark.parametrize("M,N,K,be", [
    (3, 64, 1024, 256), (1, 32, 512, 128), (3, 64, 262144, 512)])
def test_dg_diff_cost_rule_matches_closed_form(M, N, K, be):
    fn = functools.partial(ops.dg_diff, block_e=be)
    c = count_fn(fn, f32(M, N, N), f32(N, K))
    # D_m fetched once per m, the ut slab once per (m, e) program
    assert c["f_op_float32_madd"] == M * N * N * K
    assert c[BYTES_IN_FEATURE] == 4 * (M * N * N + M * N * K)
    assert c[BYTES_OUT_FEATURE] == 4 * M * N * K
    assert c["f_sync_grid_programs"] == M * K // be


def test_block_fetches_revisit_elision():
    # an index that ignores the fastest axis is reused across it
    assert block_fetches((2, 3, 4), (0, 1)) == 6
    # one that reads the fastest axis refetches every step
    assert block_fetches((2, 3, 4), (0, 2)) == 24
    # a single k step: A's (i, 0) block survives the j sweep
    assert block_fetches((2, 3, 1), (0, 2)) == 2
    assert block_fetches((4, 1), (1,)) == 1


def test_counting_runs_no_kernel():
    before = (tmm.launches, tst.launches, tdg.launches)
    count_fn(ops.matmul, f32(4096, 4096), f32(4096, 4096))
    count_fn(ops.stencil5, torch.ones(256, 256))
    assert (tmm.launches, tst.launches, tdg.launches) == before


# each generator's smallest variants (INTERSECT match)
_SMALLEST_TAGS = [
    "matmul_sq", "flops", "gmem", "launch", "lmem", "sync", "overlap", "dg",
    "stencil", "dtype:float32", "nelements:262144,4096,16,4194304",
    "iters:64,16", "n_dot:128", "n:256", "tile:16", "n_arrays:1,2",
    "working_set:2048", "steps:64", "m:16", "nelements_dg:8192",
    "n_grid:1024"]


def _kernel(mod, name):
    kerns = mod.KernelCollection(mod.ALL_GENERATORS).generate_kernels(
        _SMALLEST_TAGS, mod.MatchCondition.INTERSECT)
    return {k.name: k for k in kerns}[name]


_ref_kernel = functools.partial(_kernel, juipick)
_port_kernel = functools.partial(_kernel, tuipick)


#: reference count − port count, per kernel (ROADMAP queue C)
COUNT_DIFFERENCES = {
    "matmul_sq_n256_float32_pfFalse_t16": {},
    # jaxpr loop counter of fori_loop
    "madd_n4096_i64_float32": {"f_op_int32_add": 64},
    "dotflops_n128_i16_float32": {},
    # strided: PyTorch's .T is a view; the port materializes the result
    # with one contiguous copy the reference's transposes do not need
    "stream_strided_n262144_a1_float32": {"f_mem_contig_float32_store":
                                          -262144},
    "stream_strided_n262144_a2_float32": {"f_mem_contig_float32_store":
                                          -262144},
    # jnp.roll is invisible to the reference's walker (nested jit)
    "stream_shift_n262144_a2_float32": {},
    # jnp indexing normalizes negative indices (int32 add + select)
    "stream_gather_n262144_a2_float32": {"f_op_int32_add": 524288,
                                         "f_mem_contig_int32_store": 1048576},
    "stream_contig_n262144_a2_float32": {},
    "empty_n16": {},
    # reference: dynamic_slice (gather class), reshape/squeeze stores,
    # int32 index arithmetic; the port's panel slices are free views
    "matmul_sq_n256_float32_pfTrue_t16": {
        "f_mem_gather_float32_load": 131072,
        "f_mem_contig_float32_store": 196608,
        "f_mem_contig_int32_store": 48, "f_op_int32_add": 32,
        "f_op_int32_mul": 16},
    # fori_loop's counter, as for madd
    "onchip_w2048_i64_float32": {"f_op_int32_add": 64},
    "loopstep_s64": {},
    # m = 16, the smallest with a loop on the reference's count lattice:
    # fori_loop's counter
    "overlap_n4194304_m16_float32": {"f_op_int32_add": 16},
    # torch.einsum permutes its operands (views, counted as strided
    # traffic as the reference counts transpose); XLA's dot_general
    # takes them as they are
    "dg_basic_k8192_n64_m3_float32": {"f_mem_strided_float32_load": -1073152,
                                      "f_mem_strided_float32_store":
                                      -1073152},
    # the same, twice over; and the reference's reshape of dmat is a
    # contiguous store, the port's a free view
    "dg_u_pf_k8192_n64_m3_float32": {"f_mem_strided_float32_load": -2646016,
                                     "f_mem_strided_float32_store": -2646016,
                                     "f_mem_contig_float32_store": 12288},
    # each GEMM written into its slice of the result, as scan stacks it
    "dg_dmat_pf_k8192_n64_m3_float32": {},
    "dg_dmat_pf_T_k8192_n64_m3_float32": {},
    "stencil_roll_n1024_float32": {},
    # the reference counts its five slices as contiguous stores; the
    # port's are free views
    "stencil_slice_n1024_float32": {"f_mem_contig_float32_store": 5222420},
}


@pytest.mark.parametrize("name", sorted(COUNT_DIFFERENCES))
def test_generator_counts_match_reference(name):
    want = _ref_kernel(name).counts()
    got = _port_kernel(name).counts()
    diff = {k: want[k] - got[k] for k in set(want) | set(got)
            if want[k] != got[k]}
    assert diff == COUNT_DIFFERENCES[name]


def test_counted_range_emits_loop_steps_only_while_counting():
    def fn(x):
        for _ in counted_range(5):
            x = x * 2.0
        return x

    c = count_fn(fn, f32(8))
    assert c["f_sync_loop_steps"] == 5
    assert c["f_op_float32_mul"] == 40
    assert list(counted_range(3)) == [0, 1, 2]


def test_counted_loop_counts_as_counted_range():
    """One counted step scaled by the trip count gives what a counted
    step-by-step loop gives, and eagerly both compute the same."""
    def by_range(x, w):
        for _ in counted_range(7):
            x = torch.roll(x, 1) * w + x.sum()
        return x

    def by_loop(x, w):
        return counted_loop(7, lambda i, x: torch.roll(x, 1) * w + x.sum(),
                            x)

    args = (f32(16), f32(16))
    assert count_fn(by_loop, *args) == count_fn(by_range, *args)
    assert count_fn(by_loop, *args)["f_sync_loop_steps"] == 7
    x = torch.arange(16, dtype=torch.float32)
    w = torch.full((16,), 0.5)
    torch.testing.assert_close(by_loop(x, w), by_range(x, w), rtol=0,
                               atol=0)
    zero = count_fn(lambda x: counted_loop(0, lambda i, x: x * 2.0, x),
                    f32(16))
    assert zero["f_op_float32_mul"] == 0 and zero["f_sync_loop_steps"] == 0


@pytest.mark.parametrize("body", [
    lambda i, x: x[:-1],
    lambda i, x: x.double(),
    lambda i, x: (x, x),
])
def test_counted_loop_rejects_a_body_that_changes_the_carry(body):
    for run in (lambda f, x: count_fn(f, x), lambda f, x: f(x)):
        with pytest.raises(ValueError, match="carry"):
            run(lambda x: counted_loop(3, body, x), torch.ones(4))


@pytest.mark.parametrize("fn,shape,want", [
    (lambda x: x.T.contiguous(), (4, 6),
     {"f_mem_strided_float32_load": 24, "f_mem_strided_float32_store": 24,
      "f_mem_contig_float32_store": 24}),
    (lambda x: torch.cat([x, x]), (4, 6), {"f_mem_concat_float32_store": 48}),
    (lambda x: x ** 7, (4, 6), {"f_op_float32_mul": 96}),
    (lambda x: x.sum(), (4, 6), {"f_op_float32_add": 24}),
    (lambda x: torch.exp(x).reshape(-1)[:5], (4, 6),
     {"f_op_float32_transc": 24}),
    (lambda x: x.to(torch.bfloat16), (4, 6),
     {"f_mem_contig_bfloat16_store": 24}),
    (lambda x: torch.maximum(x, x), (4, 6), {"f_op_float32_cmp": 24}),
])
def test_aten_vocabulary(fn, shape, want):
    c = count_fn(fn, torch.empty(shape, device="meta"))
    assert {k: v for k, v in c.items() if k != "f_sync_launch_kernel"} \
        == want


def test_unknown_hand_kernel_has_no_silent_cost():
    from repro_torch.core.counting import _rule_for
    with pytest.raises(LookupError):
        _rule_for("repro_torch::not_a_kernel")


def test_counts_are_shape_only(tmp_path):
    """Counting on real CPU tensors and on meta tensors agrees."""
    k = _port_kernel("dotflops_n128_i16_float32")
    real = count_fn(k.fn, *k.make_args("cpu"))
    assert real == k.counts()
    assert np.isclose(real["f_op_float32_madd"], 16 * 128 ** 3)
