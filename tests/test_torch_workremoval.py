"""Work removal (paper §7.1.1, Algorithm 3): the port's ``remove_work``
against the reference's.

* The reference's two cases (``tests/test_uipick.py``: a stripped tiled
  matmul returns Σb; a stripped ``tanh`` in a 5-step loop reads its
  operand 5 times), written with ``counted_range``/``counted_loop``, on
  the same numpy inputs through JAX ``remove_work`` on the CPU and the
  port: the values agree to rel 1e-5.
* Stripped counts against the reference's ``count_fn`` of its stripped
  kernel, feature by feature, with every difference pinned
  (:data:`STRIPPED_COUNT_DIFFERENCES`, ROADMAP queue C).
* The map of the reference's ``COMPUTE_PRIMS`` to the aten ops the port
  strips; in-place and ``out=`` ops; a removed argument's view chain; a
  ``repro_torch::*`` op run verbatim; the stripped ``matmul_sq`` battery
  kernel's counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.counting import count_fn as jcount_fn
from repro.core.workremoval import COMPUTE_PRIMS
from repro.core.workremoval import remove_work as jremove_work
from repro_torch.core import uipick as tuipick
from repro_torch.core.counting import count_fn, counted_loop, counted_range
from repro_torch.core.workremoval import (
    COMPUTE_OPS,
    OUTPUT_WEIGHT,
    PRIM_TO_ATEN,
    remove_work,
)
from repro_torch.kernels import dg_diff as tdg
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dg_diff_ref

T = 16          # panel width of the tiled matmul
N = 64


def _inputs():
    a = np.ones((N, N), np.float32)
    b = (np.arange(N * N, dtype=np.float32) / 4096).reshape(N, N)
    return a, b


def _jax_tiled(a, b):
    def body(acc, i):
        ak = jax.lax.dynamic_slice_in_dim(a, i * T, T, axis=1)
        bk = jax.lax.dynamic_slice_in_dim(b, i * T, T, axis=0)
        return acc + ak @ bk, None

    acc, _ = jax.lax.scan(body, jnp.zeros((N, N)), jnp.arange(N // T))
    return acc


def _tiled_range(a, b):
    acc = torch.zeros((N, N), dtype=a.dtype, device=a.device)
    for i in counted_range(N // T):
        acc = acc + a[:, i * T:(i + 1) * T] @ b[i * T:(i + 1) * T]
    return acc


def _tiled_loop(a, b):
    def body(i, acc):
        return acc + a[:, i * T:(i + 1) * T] @ b[i * T:(i + 1) * T]

    return counted_loop(N // T, body, torch.zeros((N, N), dtype=a.dtype,
                                                  device=a.device))


TILED = {"counted_range": _tiled_range, "counted_loop": _tiled_loop}


@pytest.mark.parametrize("loop", sorted(TILED))
def test_work_removal_preserves_kept_access_and_value(loop):
    a, b = _inputs()
    want = float(jax.jit(jremove_work(_jax_tiled, jnp.asarray(a),
                                      jnp.asarray(b), remove_args=(0,)))(
        jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = float(remove_work(TILED[loop], ta, tb, remove_args=(0,))(ta, tb))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(float(b.astype(np.float64).sum()), rel=1e-5)


def _jax_rereader(x):
    def body(acc, _):
        return acc + jnp.sum(jnp.tanh(x)), None

    acc, _ = jax.lax.scan(body, jnp.float32(0), None, length=5)
    return acc


def _rereader_range(x):
    acc = torch.zeros((), dtype=x.dtype)
    for _ in counted_range(5):
        acc = acc + torch.sum(torch.tanh(x))
    return acc


def _rereader_loop(x):
    return counted_loop(5, lambda i, acc: acc + torch.sum(torch.tanh(x)),
                        torch.zeros((), dtype=x.dtype))


REREADER = {"counted_range": _rereader_range, "counted_loop": _rereader_loop}


@pytest.mark.parametrize("loop", sorted(REREADER))
def test_work_removal_keeps_afr(loop):
    """The stripped ``tanh`` site runs 5 times, so its operand is read 5
    times: the access-to-footprint ratio survives."""
    x = np.ones((128,), np.float32)
    want = float(jax.jit(jremove_work(_jax_rereader, jnp.asarray(x)))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x)
    got = float(remove_work(REREADER[loop], tx)(tx))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(5 * 128, rel=1e-4)


#: reference − port counts of the stripped tiled matmul (ROADMAP queue C)
STRIPPED_COUNT_DIFFERENCES = {
    # the kept loads of b: the reference's dynamic_slice is a gather, the
    # port's slice a free view whose load the stripped product keeps as
    # the contiguous operand load the counter gives a product
    "f_mem_gather_float32_load": 4096.0,
    "f_mem_contig_float32_load": -4096.0,
    # the reference stores zeros for the removed a (4096), for the dead
    # dynamic_slice of a (1024 a step) and for each product's proxy
    # (4096 a step), where the port's removed argument, dead slice and
    # proxy are views; the port stores the zero scalar the removed
    # argument broadcasts and the accumulator's (2)
    "f_mem_contig_float32_store": 4096.0 + 4 * (1024.0 + 4096.0) - 2.0,
    # the reference adds each contribution to its proxy's zeros (4096 a
    # step) and folds each scan step's outputs at 1e-30 (4096 adds and a
    # multiply a step), which a Python loop's body does not expose; its
    # scalar bookkeeping takes four adds a step where the port's
    # accumulator takes one
    "f_op_float32_add": 4 * (4096.0 + 4096.0) + 12.0,
    "f_op_float32_mul": 4.0,
    # jax's index arithmetic for dynamic_slice; the port's are Python ints
    "f_op_int32_add": 8.0,
    "f_op_int32_mul": 8.0,
    "f_mem_contig_int32_store": 12.0,
}

#: reference − port counts of the unstripped tiled matmul: both count
#: the product's contiguous operand loads, the reference also its slices
#: as gathers (``tests/test_torch_counting.py`` pins the same on
#: matmul_sq)
UNSTRIPPED_COUNT_DIFFERENCES = {
    "f_mem_gather_float32_load": 8192.0,
    "f_op_int32_add": 8.0,
    "f_op_int32_mul": 8.0,
    "f_mem_contig_int32_store": 12.0,
}


def _diff(want, got):
    return {k: want[k] - got[k] for k in set(want) | set(got)
            if want[k] != got[k]}


@pytest.mark.parametrize("loop", sorted(TILED))
def test_stripped_counts_match_the_reference_feature_by_feature(loop):
    a, b = _inputs()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    j_stripped = jcount_fn(jremove_work(_jax_tiled, ja, jb,
                                        remove_args=(0,)), ja, jb)
    j_full = jcount_fn(_jax_tiled, ja, jb)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    t_stripped = count_fn(remove_work(TILED[loop], ta, tb,
                                      remove_args=(0,)), ta, tb)
    t_full = count_fn(TILED[loop], ta, tb)
    assert t_stripped["f_op_float32_madd"] == 0
    assert t_full["f_op_float32_madd"] == N * N * N
    assert t_stripped["f_mem_contig_float32_load"] == 4096      # b only
    assert t_full["f_mem_contig_float32_load"] == 8192          # a and b
    assert t_stripped["f_sync_loop_steps"] == N // T
    assert _diff(j_stripped, t_stripped) == STRIPPED_COUNT_DIFFERENCES
    assert _diff(j_full, t_full) == UNSTRIPPED_COUNT_DIFFERENCES


def test_every_compute_prim_maps_to_aten_ops():
    """Each of the reference's 26 ``COMPUTE_PRIMS`` names the aten ops
    stripped in its place, each an op PyTorch dispatches."""
    assert len(COMPUTE_PRIMS) == 26
    assert set(PRIM_TO_ATEN) == COMPUTE_PRIMS
    for prim, names in PRIM_TO_ATEN.items():
        assert names, prim
        for name in names:
            assert hasattr(torch.ops.aten, name), (prim, name)
            assert name in COMPUTE_OPS
    assert {"_softmax", "_log_softmax"} <= COMPUTE_OPS
    # add, index arithmetic and copies are the kept loads' plumbing
    assert not {"add", "sub", "copy", "index", "sum"} & COMPUTE_OPS


def test_in_place_and_out_ops_land_the_proxy_in_the_destination():
    """``mm(out=r)`` fills r with its operands' sum; ``r.mul_(y)`` then
    reads r and y and leaves its own proxy in r."""
    seen = []

    def fn(x, y):
        r = x.new_empty((4, 4))
        torch.mm(x, y, out=r)
        seen.append(r.clone())
        r.mul_(y)
        seen.append(r)
        return r

    x = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 16
    y = torch.full((4, 4), 0.5)
    c1 = float(x.sum() + y.sum())
    c2 = 16 * c1 + float(y.sum())
    got = float(remove_work(fn, x, y)(x, y))
    assert got == pytest.approx(c1 + c2 + OUTPUT_WEIGHT * 16 * c2,
                                rel=1e-6)
    assert torch.equal(seen[0], torch.full((4, 4), c1))
    assert torch.equal(seen[1], torch.full((4, 4), c2))
    c = count_fn(remove_work(fn, x, y), x, y)
    assert c["f_op_float32_madd"] == 0 and c["f_op_float32_mul"] == 1


def test_a_removed_argument_s_chain_adds_nothing():
    """Views of a removed argument stay views the counter never sees
    (no strided traffic for the transpose); a non-view op on them yields
    dead zeros; a product of dead and kept operands reads the kept one
    only."""
    def fn(a, b):
        u = a.t()[1:].contiguous() + 1.0
        return torch.tanh(b).sum() + (u @ b).sum()

    a, b = torch.ones(8, 8), torch.arange(64.0).reshape(8, 8) / 64
    stripped = remove_work(fn, a, b, remove_args=(0,))
    got = float(stripped(a, b))
    # tanh reads b, the product reads b (its dead operand u adds 0); the
    # sums of the proxies (64 and 56 elements of Σb) run verbatim
    sb = float(b.sum())
    assert got == pytest.approx(2 * sb + OUTPUT_WEIGHT * 120 * sb,
                                rel=1e-6)
    c = count_fn(stripped, a, b)
    assert c["f_mem_strided_float32_load"] == 0
    assert c["f_mem_contig_float32_load"] == 64          # b only
    assert count_fn(fn, a, b)["f_mem_strided_float32_load"] == 64


def test_hand_kernel_runs_verbatim():
    """A ``repro_torch::*`` op is not stripped: its output feeds the
    stripped ``tanh`` with the plain version's values, and the counter
    still prices it by its cost rule."""
    def fn(d, ut):
        return torch.tanh(ops.dg_diff(d, ut, block_e=64))

    g = np.random.default_rng(3)
    d = torch.from_numpy(g.standard_normal((2, 8, 8)).astype(np.float32))
    ut = torch.from_numpy(g.standard_normal((8, 128)).astype(np.float32))
    before = tdg.launches
    got = float(remove_work(fn, d, ut)(d, ut))
    assert tdg.launches == before                       # CPU: plain path
    want = float(dg_diff_ref(d.double(), ut.double()).sum())
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    c = count_fn(remove_work(fn, d, ut), d, ut)
    assert c["f_op_float32_madd"] == 2 * 8 * 8 * 128
    assert c["f_op_float32_transc"] == 0


def test_stripped_matmul_sq_battery_kernel_counts():
    """The phase-14 kernel at n 256: 0 madds, b's n² contiguous loads
    against 2n², one loop step a tile."""
    (kern,) = tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
        .generate_kernels(["matmul_sq", "n:256", "dtype:float32",
                           "prefetch:True", "tile:64"])
    n = 256
    args = kern.make_args("cpu")
    stripped = remove_work(kern.fn, *args, remove_args=(0,))
    cs = count_fn(stripped, *kern.make_args("meta"))
    co = kern.counts()
    assert cs["f_op_float32_madd"] == 0 and co["f_op_float32_madd"] == n ** 3
    assert cs["f_mem_contig_float32_load"] == n * n
    assert co["f_mem_contig_float32_load"] == 2 * n * n
    assert cs["f_sync_loop_steps"] == co["f_sync_loop_steps"] == n // 64
    assert float(stripped(*args)) == pytest.approx(
        float(args[1].double().sum()), abs=1e-5 * float(args[1].abs().sum()))


def test_remove_args_must_name_tensor_arguments():
    with pytest.raises(ValueError, match="remove_args"):
        remove_work(lambda x, k: x * k, torch.ones(2), 3, remove_args=(1,))
