"""The paper's two measurement kernels in the port, against the JAX
package on the CPU.

* ``ops.stream_strided`` / ``ops.madd_throughput`` (their plain
  versions, the tensors lie on the CPU) against ``repro.kernels.ops`` in
  Pallas interpret mode at ``tests/test_kernels.py``'s shapes and f32
  tolerance, on the same numpy inputs.
* Their cost rules: arithmetic against the reference counter run on the
  reference's plain oracle bodies (``repro.kernels.ref.stream_ref`` /
  ``madd_ref`` through ``repro.core.counting.count_fn``; the reference's
  static Pallas costing does not run under the installed jax, ROADMAP
  queue C), traffic against the closed form of the block-refetch rule.
* ``predict --kernel`` prices both from a profile with zero timings.

The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.counting import count_fn as jcount_fn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.analysis.kernelcost import BYTES_IN_FEATURE, BYTES_OUT_FEATURE
from repro_torch.analysis.targets import f32
from repro_torch.core.counting import count_fn
from repro_torch.kernels import microbench as tmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_kernels.py, float32


def rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port: torch.Tensor, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32),
                               **TOL)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("n_arrays", [1, 3, 9])
def test_stream_strided_matches_reference(stride, n_arrays):
    arrs = [rn(20 + j, 8192) for j in range(n_arrays)]
    want = jops.stream_strided([jnp.asarray(a) for a in arrs], block=256,
                               stride=stride)
    got = tops.stream_strided([torch.from_numpy(a) for a in arrs],
                              block=256, stride=stride)
    assert got.shape == (8192 // stride,)
    _close(got, want)


@pytest.mark.parametrize("S,iters,block", [
    (4096, 32, 1024), (4096, 7, 8192), (2048, 64, 512)])
def test_madd_throughput_matches_reference(S, iters, block):
    x = rn(30, S)
    want = jops.madd_throughput(jnp.asarray(x), iters=iters, block=block)
    got = tops.madd_throughput(torch.from_numpy(x), iters=iters,
                               block=block)
    _close(got, want)
    # the oracle alone, at the reference's keywords and defaults
    _close(tref.madd_ref(torch.from_numpy(x), iters=iters),
           jref.madd_ref(jnp.asarray(x), iters=iters))


# the reference's a = 1.000001, b = 1e-7 move each output by ~3e-5 of
# itself over 32 steps, inside the tolerance; with these every step is
# visible, so a body that skips steps cannot pass
VISIBLE = dict(a=0.999, b=0.01)


@pytest.mark.parametrize("S,iters,block", [(4096, 32, 1024), (2048, 64, 512)])
def test_madd_throughput_chain_is_visible(S, iters, block):
    x = rn(31, S)
    want = jops.madd_throughput(jnp.asarray(x), iters=iters, block=block,
                                **VISIBLE)
    got = tops.madd_throughput(torch.from_numpy(x), iters=iters,
                               block=block, **VISIBLE)
    _close(got, want)
    # a kernel running half the chain, or none of it, fails on every element
    for short in (iters // 2, 0):
        wrong = tref.madd_ref(torch.from_numpy(x), iters=short, **VISIBLE)
        room = TOL["atol"] + TOL["rtol"] * np.abs(np.asarray(want))
        assert np.all(np.abs(wrong.numpy() - np.asarray(want)) > room)


def test_cpu_path_launches_nothing_and_wrappers_validate():
    before = dict(tmb.launches)
    tops.stream_strided([torch.ones(1024)], block=256, stride=2)
    tops.madd_throughput(torch.ones(1024), iters=2)
    assert tmb.launches == before
    with pytest.raises(ValueError, match="n_out·block·stride"):
        tops.stream_strided([torch.ones(1000)], block=256)
    with pytest.raises(ValueError, match="does not tile"):
        tops.madd_throughput(torch.ones(3000), block=2048)


# divisors the stream wrapper can pass: block (the one-float path) or
# block / 4, for every block of an array below 2^31 elements
_SMALL_DIVISORS = range(1, 4097)
_LARGE_DIVISORS = sorted(
    {2 ** p + o for p in range(12, 31) for o in (-1, 0, 1)}
    | {2 ** 31 - 1, 2 ** 31 - 2, 3 * 2 ** 29, 10 ** 9}
    | set(np.random.default_rng(5).integers(4097, 2 ** 31, 200).tolist()))


@pytest.mark.parametrize("divisors", [_SMALL_DIVISORS, _LARGE_DIVISORS],
                         ids=["d<=4096", "d>4096"])
def test_stream_magic_divisor_is_floor_division(divisors):
    """``(n * magic) >> shift == n // d`` for every index n < 2^31 the
    kernels take: the bound of ``magic_divisor``'s proof, n·e < 2^shift
    with e = magic·d − 2^shift, holds at n = 2^31 − 1 for each divisor,
    and the product agrees with ``//`` at each multiple's edges, at
    2^31 − 1 and at seeded indices."""
    rng = np.random.default_rng(6)
    for d in divisors:
        magic, shift = tmb.magic_divisor(d)
        assert 0 < magic < 2 ** 32 and 31 <= shift <= 62
        e = magic * d - 2 ** shift
        assert 0 <= e < d and (2 ** 31 - 1) * e < 2 ** shift
        q = rng.integers(0, (2 ** 31 - 1) // d + 1, 64, dtype=np.uint64)
        n = np.concatenate([q * d, q * d + d - 1, q * d - (q > 0),
                            rng.integers(0, 2 ** 31, 64, dtype=np.uint64),
                            np.array([0, 2 ** 31 - 1], dtype=np.uint64)])
        n = n[n < 2 ** 31]
        np.testing.assert_array_equal(
            (n * np.uint64(magic)) >> np.uint64(shift), n // np.uint64(d))


def test_stream_magic_divisor_exhaustive_on_small_indices():
    """Every index below 2^16 against every divisor up to 64."""
    n = np.arange(2 ** 16, dtype=np.uint64)
    for d in range(1, 65):
        magic, shift = tmb.magic_divisor(d)
        np.testing.assert_array_equal(
            (n * np.uint64(magic)) >> np.uint64(shift), n // np.uint64(d))


def _arith(counts):
    return {k: v for k, v in counts.items() if k.startswith("f_op_")}


@pytest.mark.parametrize("S,block,stride,n_arrays", [
    (8192, 256, 2, 2), (8192, 256, 1, 1), (8192, 256, 4, 3),
    (8192, 256, 2, 9), (2 ** 26, 512, 4, 2)])
def test_stream_cost_rule(S, block, stride, n_arrays):
    fn = functools.partial(tops.stream_strided, block=block, stride=stride)
    c = count_fn(fn, [f32(S) for _ in range(n_arrays)])
    n_out = S // (block * stride)
    # traffic: every input block i·stride fetched once, output block i once
    assert c[BYTES_IN_FEATURE] == 4 * n_arrays * n_out * block
    assert c[BYTES_OUT_FEATURE] == 4 * n_out * block
    assert c["f_mem_contig_float32_load"] == n_arrays * n_out * block
    assert c["f_mem_contig_float32_store"] == n_out * block
    assert c["f_sync_grid_programs"] == n_out
    assert c["f_sync_launch_kernel"] == 1
    if S > 8192:
        return
    want = jcount_fn(
        lambda *a: jref.stream_ref(list(a), block=block, stride=stride),
        *[jnp.zeros(S, jnp.float32) for _ in range(n_arrays)])
    # reference − port: the oracle seeds its sum with zeros (one more
    # add per output; the kernel body seeds it with the first input), and
    # its row slice [::stride] is a gather whose row indices cost one
    # int32 mul and add per row read
    diff = {k: want[k] - c[k] for k in set(_arith(want)) | set(_arith(c))
            if want[k] != c[k]}
    rows = {} if stride == 1 else {"f_op_int32_add": n_arrays * n_out,
                                   "f_op_int32_mul": n_arrays * n_out}
    assert diff == {"f_op_float32_add": n_out * block, **rows}


@pytest.mark.parametrize("S,iters,block", [
    (4096, 32, 4096), (4096, 32, 1024), (2 ** 24, 256, 2048)])
def test_madd_cost_rule(S, iters, block):
    fn = functools.partial(tops.madd_throughput, iters=iters, block=block)
    c = count_fn(fn, f32(S))
    programs = S // block
    assert c[BYTES_IN_FEATURE] == c[BYTES_OUT_FEATURE] == 4 * S
    assert c["f_mem_contig_float32_load"] == S
    assert c["f_mem_contig_float32_store"] == S
    assert c["f_sync_grid_programs"] == programs
    assert c["f_sync_loop_steps"] == iters * programs
    if S > 4096:
        return
    want = jcount_fn(functools.partial(jref.madd_ref, iters=iters),
                     jnp.zeros(S, jnp.float32))
    diff = {k: want[k] - c[k] for k in set(_arith(want)) | set(_arith(c))
            if want[k] != c[k]}
    # the jaxpr's fori_loop counter, as COUNT_DIFFERENCES pins it for
    # flops_madd_pattern
    assert diff == {"f_op_int32_add": iters}
    if programs == 1:   # one grid program runs the oracle's loop once
        assert c["f_sync_loop_steps"] == want["f_sync_loop_steps"]


def test_predict_cli_prices_both_kernels_with_zero_timings(tmp_path):
    from repro_torch.profiles.cli import main as cli_main
    profile = tmp_path / "apex.json"
    assert cli_main(["--zoo", "--smoke", "--synthetic", "apex",
                     "--trials", "2", "--out", str(profile)]) == 0
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibrate", "predict",
         str(profile), "--kernel", "kernels.ops.stream_strided",
         "--kernel", "kernels.ops.madd_throughput", "--device", "cpu",
         "--expect-zero-timings", "--explain", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "timings_performed=0 batched_evals=1" in out.stdout
    assert "kernels.ops.madd_throughput" in out.stdout
