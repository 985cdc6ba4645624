"""The hand-written CUDA kernels on the card, against their plain
PyTorch versions at the ``tests/test_kernels.py`` shapes and tolerances
(float32 kernels against the plain version evaluated in float64).

Every test here carries the ``gpu`` marker and skips (inside a fixture)
where no card is visible.  The file imports neither jax nor the
reference; skipping the repository's ``conftest.py`` (which imports
jax) lets it run on a machine without jax::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import matmul_tiled as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, plain, *args, dt="float32"):
    """Float32 kernels are held against the plain version on float64
    copies of their inputs (the kernel's own error, not the difference of
    two f32 summation orders); bf16 against the plain version in bf16."""
    if dt == "float32":
        args = tuple(x.double() for x in args)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               plain(*args).double().cpu().numpy(),
                               **TOL[dt])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 128, 512, 128, 128, 64),
    (512, 512, 256, 256, 128, 256),
])
def test_matmul_kernel_on_card(cuda, dt, m, k, n, bm, bn, bk):
    tdt = DTYPES[dt]
    a = torch.from_numpy(rn(1, m, k)).to(cuda, tdt)
    b = torch.from_numpy(rn(2, k, n)).to(cuda, tdt)
    before = tmm.launches
    got = tops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
    assert tmm.launches == before + 1
    _check(got, tref.matmul_ref, a, b, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,bm,bn", [
    (256, 256, 128, 128), (256, 512, 256, 256), (128, 128, 64, 128)])
def test_stencil5_kernel_on_card(cuda, m, n, bm, bn):
    u = torch.from_numpy(rn(10, m, n)).to(cuda)
    got = tops.stencil5(u, block_m=bm, block_n=bn)
    _check(got, tref.stencil5_ref, u)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,be", [(3, 64, 1024, 256), (1, 32, 512, 512)])
def test_dg_diff_kernel_on_card(cuda, M, N, K, be):
    d = torch.from_numpy(rn(11, M, N, N)).to(cuda)
    ut = torch.from_numpy(rn(12, N, K)).to(cuda)
    got = tops.dg_diff(d, ut, block_e=be)
    _check(got, tref.dg_diff_ref, d, ut)


@pytest.mark.gpu
def test_cuda_path_raises_on_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        tops.stencil5(torch.ones(64, 64, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        tops.matmul(torch.ones(64, 128, device=cuda).T,
                    torch.ones(64, 64, device=cuda))
