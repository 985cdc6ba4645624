"""The port's kernel wrappers against the JAX package's.

On the CPU each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version (the tensor lies on the CPU); it is held against
the reference ``repro.kernels.ops`` wrapper in Pallas interpret mode at
the ``tests/test_kernels.py`` shapes and tolerances, on the same numpy
inputs.  The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import dg_diff as tdg
from repro_torch.kernels import matmul_tiled as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil5 as tst

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dt: str):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(port: torch.Tensor, ref, dt: str):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 128, 512, 128, 128, 64),
    (512, 512, 256, 256, 128, 256),
])
def test_matmul_matches_reference(dt, m, k, n, bm, bn, bk):
    (ja, ta), (jb, tb) = _both(rn(1, m, k), dt), _both(rn(2, k, n), dt)
    want = jops.matmul(ja, jb, block_m=bm, block_n=bn, block_k=bk)
    _close(tops.matmul(ta, tb, block_m=bm, block_n=bn, block_k=bk), want, dt)
    _close(tref.matmul_ref(ta, tb), want, dt)


@pytest.mark.parametrize("m,n,bm,bn", [
    (256, 256, 128, 128), (256, 512, 256, 256), (128, 128, 64, 128)])
def test_stencil5_matches_reference(m, n, bm, bn):
    ju, tu = _both(rn(10, m, n), "float32")
    want = jops.stencil5(ju, block_m=bm, block_n=bn)
    _close(tops.stencil5(tu, block_m=bm, block_n=bn), want, "float32")


@pytest.mark.parametrize("M,N,K,be", [(3, 64, 1024, 256), (1, 32, 512, 512)])
def test_dg_diff_matches_reference(M, N, K, be):
    (jd, td), (ju, tu) = _both(rn(11, M, N, N), "float32"), \
        _both(rn(12, N, K), "float32")
    want = jops.dg_diff(jd, ju, block_e=be)
    _close(tops.dg_diff(td, tu, block_e=be), want, "float32")


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version: no launch is counted."""
    before = (tmm.launches, tst.launches, tdg.launches)
    tops.matmul(torch.ones(8, 8), torch.ones(8, 8))
    tops.stencil5(torch.ones(8, 8))
    tops.dg_diff(torch.ones(1, 8, 8), torch.ones(8, 16))
    assert (tmm.launches, tst.launches, tdg.launches) == before


@pytest.mark.parametrize("call", [
    lambda: tops.matmul(torch.ones(96, 64), torch.ones(64, 64), block_m=64),
    lambda: tops.stencil5(torch.ones(96, 64), block_m=64),
    lambda: tops.dg_diff(torch.ones(1, 8, 8), torch.ones(8, 96), block_e=64),
    lambda: tops.matmul(torch.ones(8, 4), torch.ones(8, 8)),
])
def test_wrappers_reject_blocks_that_do_not_tile(call):
    with pytest.raises(ValueError):
        call()
