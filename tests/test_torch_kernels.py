"""The port's kernel wrappers against the JAX package's.

On the CPU each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version (the tensor lies on the CPU); it is held against
the reference ``repro.kernels.ops`` wrapper in Pallas interpret mode at
the ``tests/test_kernels.py`` shapes and tolerances, on the same numpy
inputs.  The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro_torch.analysis.targets import f32
from repro_torch.core.counting import count_fn
from repro_torch.kernels import dg_diff as tdg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import matmul_tiled as tmm
from repro_torch.kernels import microbench as tmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_cell as tsc
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
    (192, 80, 320, 64, 64, 80),
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


def _e(*shape):
    return torch.empty(shape, device="cuda")


#: op name → (wrapper call on tensors made where it runs, output shape,
#: that kernel's launch count)
FAKE_CARD_CALLS = {
    "matmul_tiled": (lambda: tops.matmul(_e(64, 32), _e(32, 16)), (64, 16),
                     lambda: tmm.launches),
    "stencil5": (lambda: tops.stencil5(_e(32, 32)), (32, 32),
                 lambda: tst.launches),
    "dg_diff": (lambda: tops.dg_diff(_e(3, 8, 8), _e(8, 64), block_e=32),
                (3, 8, 64), lambda: tdg.launches),
    "stream_strided": (lambda: tops.stream_strided([_e(1024)] * 2, block=256,
                                                   stride=2), (512,),
                       lambda: tmb.launches["stream_strided"]),
    "madd_throughput": (lambda: tops.madd_throughput(_e(2048)), (2048,),
                        lambda: tmb.launches["madd_throughput"]),
    "flash_attention": (lambda: tops.flash_attention(
        _e(1, 64, 2, 16), _e(1, 64, 1, 16), _e(1, 64, 1, 16), block_q=32,
        block_k=32), (1, 64, 2, 16), lambda: tfa.launches),
    "mamba2_ssd": (lambda: tops.mamba2_ssd(_e(1, 64, 2, 8), _e(1, 64, 2),
                                           _e(1, 64, 2, 4), _e(1, 64, 2, 4),
                                           chunk=32), (1, 64, 2, 8),
                   lambda: tssd.launches),
    "slstm_cell": (lambda: tops.slstm_cell(_e(1, 4, 4, 2, 8), _e(2, 8, 4, 8),
                                           _e(4, 2, 8)), (1, 4, 2, 8),
                   lambda: tsc.launches),
}


@pytest.mark.parametrize("op", sorted(FAKE_CARD_CALLS))
def test_fake_card_tensors_meet_the_op_and_launch_nothing(op):
    """The one route to a kernel: a wrapper launches only on a tensor with
    data on the card.  Fake tensors on ``cuda`` (what the counter passes)
    meet the custom op, whose fake impl gives the output's shape, and the
    op has no CUDA kernel of its own to reach."""
    call, shape, launches = FAKE_CARD_CALLS[op]
    before = launches()
    with FakeTensorMode():
        out = call()
    assert (tuple(out.shape), out.device.type) == (shape, "cuda")
    assert launches() == before
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(
        f"repro_torch::{op}", "CUDA")


@pytest.mark.parametrize("call", [
    lambda: tops.matmul(torch.ones(96, 64), torch.ones(64, 64), block_m=64),
    lambda: tops.stencil5(torch.ones(96, 64), block_m=64),
    lambda: tops.dg_diff(torch.ones(1, 8, 8), torch.ones(8, 96), block_e=64),
    lambda: tops.matmul(torch.ones(8, 4), torch.ones(8, 8)),
])
def test_wrappers_reject_blocks_that_do_not_tile(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# cost rules: only the port's staging term follows the CUDA kernels
# ---------------------------------------------------------------------------

_bf16 = functools.partial(torch.empty, dtype=torch.bfloat16, device="meta")

#: (call, shapes) → every feature but ``f_vmem_*``: the reference
#: kernels' features (madds, traffic, transcendentals, grid programs,
#: ...), which no design of the CUDA kernels may move
REFERENCE_FEATURES = {
    "flash bf16 D 112 causal (route wgmma)": (
        functools.partial(tops.flash_attention, causal=True, block_q=32,
                          block_k=32),
        (_bf16(1, 160, 4, 112), _bf16(1, 160, 2, 112),
         _bf16(1, 160, 2, 112)),
        {"f_mem_contig_bfloat16_load": 788480,
         "f_mem_contig_bfloat16_store": 71680,
         "f_mem_hbm_bytes_in": 1576960, "f_mem_hbm_bytes_out": 143360,
         "f_op_float32_add": 569600, "f_op_float32_cmp": 106240,
         "f_op_float32_div": 71680, "f_op_float32_madd": 22937600,
         "f_op_float32_mul": 464000, "f_op_float32_transc": 105600,
         "f_op_int32_add": 204800, "f_op_int32_mul": 200,
         "f_sync_grid_programs": 100, "f_sync_launch_kernel": 1}),
    "flash bf16 Dk 192 Dv 128 Sq 96 Skv 160 (route wgmma)": (
        functools.partial(tops.flash_attention, causal=False, block_q=32,
                          block_k=32),
        (_bf16(1, 96, 8, 192), _bf16(1, 160, 1, 192),
         _bf16(1, 160, 1, 128)),
        {"f_mem_contig_bfloat16_load": 1376256,
         "f_mem_contig_bfloat16_store": 98304,
         "f_mem_hbm_bytes_in": 2752512, "f_mem_hbm_bytes_out": 196608,
         "f_op_float32_add": 744960, "f_op_float32_cmp": 127488,
         "f_op_float32_div": 98304, "f_op_float32_madd": 39321600,
         "f_op_float32_mul": 618240, "f_op_float32_transc": 126720,
         "f_op_int32_add": 245760, "f_op_int32_mul": 240,
         "f_sync_grid_programs": 120, "f_sync_launch_kernel": 1}),
    "flash bf16 Dk 100 Dv 60 window 48 softcap 30 (route mma_sync)": (
        functools.partial(tops.flash_attention, causal=True, window=48,
                          softcap=30.0, block_q=64, block_k=64),
        (_bf16(1, 128, 4, 100), _bf16(1, 128, 2, 100),
         _bf16(1, 128, 2, 60)),
        {"f_mem_contig_bfloat16_load": 215040,
         "f_mem_contig_bfloat16_store": 30720,
         "f_mem_hbm_bytes_in": 430080, "f_mem_hbm_bytes_out": 61440,
         "f_op_float32_add": 194560, "f_op_float32_cmp": 67072,
         "f_op_float32_div": 96256, "f_op_float32_madd": 10485760,
         "f_op_float32_mul": 193536, "f_op_float32_transc": 132096,
         "f_op_int32_add": 196608, "f_op_int32_mul": 32,
         "f_sync_grid_programs": 16, "f_sync_launch_kernel": 1}),
    "flash bf16 D 8 softcap 50 (route wgmma)": (
        functools.partial(tops.flash_attention, causal=True, softcap=50.0,
                          block_q=32, block_k=32),
        (_bf16(2, 64, 2, 8), _bf16(2, 64, 1, 8), _bf16(2, 64, 1, 8)),
        {"f_mem_contig_bfloat16_load": 10240,
         "f_mem_contig_bfloat16_store": 2048,
         "f_mem_hbm_bytes_in": 20480, "f_mem_hbm_bytes_out": 4096,
         "f_op_float32_add": 37888, "f_op_float32_cmp": 17152,
         "f_op_float32_div": 18432, "f_op_float32_madd": 262144,
         "f_op_float32_mul": 37376, "f_op_float32_transc": 33280,
         "f_op_int32_add": 32768, "f_op_int32_mul": 32,
         "f_sync_grid_programs": 16, "f_sync_launch_kernel": 1}),
    "flash f32 D 112 window 40 (route fma)": (
        functools.partial(tops.flash_attention, causal=True, window=40,
                          block_q=64, block_k=64),
        (f32(1, 128, 4, 112), f32(1, 128, 2, 112), f32(1, 128, 2, 112)),
        {"f_mem_contig_float32_load": 286720,
         "f_mem_contig_float32_store": 57344,
         "f_mem_hbm_bytes_in": 1146880, "f_mem_hbm_bytes_out": 229376,
         "f_op_float32_add": 247808, "f_op_float32_cmp": 67072,
         "f_op_float32_div": 57344, "f_op_float32_madd": 14680064,
         "f_op_float32_mul": 181248, "f_op_float32_transc": 66560,
         "f_op_int32_add": 196608, "f_op_int32_mul": 32,
         "f_sync_grid_programs": 16, "f_sync_launch_kernel": 1}),
    "flash f32 (2, 256, 8, 2, 64) causal blocks 64": (
        functools.partial(tops.flash_attention, causal=True, block_q=64,
                          block_k=64),
        (f32(2, 256, 8, 64), f32(2, 256, 2, 64), f32(2, 256, 2, 64)),
        {"f_mem_contig_float32_load": 2359296,
         "f_mem_contig_float32_store": 262144,
         "f_mem_hbm_bytes_in": 9437184, "f_mem_hbm_bytes_out": 1048576,
         "f_op_float32_add": 3178496, "f_op_float32_cmp": 1069056,
         "f_op_float32_div": 262144, "f_op_float32_madd": 134217728,
         "f_op_float32_mul": 2113536, "f_op_float32_transc": 1064960,
         "f_op_int32_add": 2097152, "f_op_int32_mul": 512,
         "f_sync_grid_programs": 256, "f_sync_launch_kernel": 1}),
    "flash f32 (1, 128, 4, 4, 64) causal blocks 64": (
        functools.partial(tops.flash_attention, causal=True, block_q=64,
                          block_k=64),
        (f32(1, 128, 4, 64), f32(1, 128, 4, 64), f32(1, 128, 4, 64)),
        {"f_mem_contig_float32_load": 163840,
         "f_mem_contig_float32_store": 32768,
         "f_mem_hbm_bytes_in": 655360, "f_mem_hbm_bytes_out": 131072,
         "f_op_float32_add": 198656, "f_op_float32_cmp": 67072,
         "f_op_float32_div": 32768, "f_op_float32_madd": 8388608,
         "f_op_float32_mul": 132096, "f_op_float32_transc": 66560,
         "f_op_int32_add": 131072, "f_op_int32_mul": 32,
         "f_sync_grid_programs": 16, "f_sync_launch_kernel": 1}),
    "flash f32 (2, 512, 8, 2, 64) causal blocks 128, 64": (
        functools.partial(tops.flash_attention, causal=True, block_q=128,
                          block_k=64),
        (f32(2, 512, 8, 64), f32(2, 512, 2, 64), f32(2, 512, 2, 64)),
        {"f_mem_contig_float32_load": 4718592,
         "f_mem_contig_float32_store": 524288,
         "f_mem_hbm_bytes_in": 18874368, "f_mem_hbm_bytes_out": 2097152,
         "f_op_float32_add": 12713984, "f_op_float32_cmp": 4268032,
         "f_op_float32_div": 524288, "f_op_float32_madd": 536870912,
         "f_op_float32_mul": 8454144, "f_op_float32_transc": 4259840,
         "f_op_int32_add": 8388608, "f_op_int32_mul": 1024,
         "f_sync_grid_programs": 512, "f_sync_launch_kernel": 1}),
    "flash bf16 (1, 256, 4, 2, 64, Dv 32) softcap 50 blocks 64": (
        functools.partial(tops.flash_attention, block_q=64, block_k=64,
                          softcap=50.0),
        (_bf16(1, 256, 4, 64), _bf16(1, 256, 2, 64), _bf16(1, 256, 2, 32)),
        {"f_mem_contig_bfloat16_load": 458752,
         "f_mem_contig_bfloat16_store": 32768,
         "f_mem_hbm_bytes_in": 917504, "f_mem_hbm_bytes_out": 65536,
         "f_op_float32_add": 663552, "f_op_float32_cmp": 267264,
         "f_op_float32_div": 294912, "f_op_float32_madd": 25165824,
         "f_op_float32_mul": 659456, "f_op_float32_transc": 528384,
         "f_op_int32_add": 524288, "f_op_int32_mul": 128,
         "f_sync_grid_programs": 64, "f_sync_launch_kernel": 1}),
    "flash bf16 gemma2-9b local layer blocks 128": (
        functools.partial(tops.flash_attention, causal=True, window=4096,
                          softcap=50.0, block_q=128, block_k=128),
        (_bf16(1, 8192, 16, 256), _bf16(1, 8192, 8, 256),
         _bf16(1, 8192, 8, 256)),
        {"f_mem_contig_bfloat16_load": 4328521728,
         "f_mem_contig_bfloat16_store": 33554432,
         "f_mem_hbm_bytes_in": 8657043456, "f_mem_hbm_bytes_out": 67108864,
         "f_op_float32_add": 4311744512, "f_op_float32_cmp": 1082261504,
         "f_op_float32_div": 1107296256, "f_op_float32_madd": 549755813888,
         "f_op_float32_mul": 4303355904, "f_op_float32_transc": 2155872256,
         "f_op_int32_add": 3221225472, "f_op_int32_mul": 131072,
         "f_sync_grid_programs": 65536, "f_sync_launch_kernel": 1}),
    "matmul (256, 384, 512) blocks 128": (
        functools.partial(tops.matmul, block_m=128, block_n=128,
                          block_k=128),
        (f32(256, 512), f32(512, 384)),
        {"f_mem_contig_float32_load": 786432,
         "f_mem_contig_float32_store": 98304,
         "f_mem_hbm_bytes_in": 3145728, "f_mem_hbm_bytes_out": 393216,
         "f_op_float32_add": 393216, "f_op_float32_madd": 50331648,
         "f_sync_grid_programs": 24, "f_sync_launch_kernel": 1}),
    "matmul (128, 128, 128) blocks 128": (
        functools.partial(tops.matmul, block_m=128, block_n=128,
                          block_k=128),
        (f32(128, 128), f32(128, 128)),
        {"f_mem_contig_float32_load": 32768,
         "f_mem_contig_float32_store": 16384,
         "f_mem_hbm_bytes_in": 131072, "f_mem_hbm_bytes_out": 65536,
         "f_op_float32_add": 16384, "f_op_float32_madd": 2097152,
         "f_sync_grid_programs": 1, "f_sync_launch_kernel": 1}),
    "matmul (512, 256, 128) blocks 64": (
        functools.partial(tops.matmul, block_m=64, block_n=64, block_k=64),
        (f32(512, 128), f32(128, 256)),
        {"f_mem_contig_float32_load": 524288,
         "f_mem_contig_float32_store": 131072,
         "f_mem_hbm_bytes_in": 2097152, "f_mem_hbm_bytes_out": 524288,
         "f_op_float32_add": 262144, "f_op_float32_madd": 16777216,
         "f_sync_grid_programs": 64, "f_sync_launch_kernel": 1}),
    "matmul 4096³ blocks 256": (
        tops.matmul, (f32(4096, 4096), f32(4096, 4096)),
        {"f_mem_contig_float32_load": 536870912,
         "f_mem_contig_float32_store": 16777216,
         "f_mem_hbm_bytes_in": 2147483648, "f_mem_hbm_bytes_out": 67108864,
         "f_op_float32_add": 268435456, "f_op_float32_madd": 68719476736,
         "f_sync_grid_programs": 4096, "f_sync_launch_kernel": 1}),
    "dg_diff (3, 64, 1024) block_e 256": (
        functools.partial(tops.dg_diff, block_e=256),
        (f32(3, 64, 64), f32(64, 1024)),
        {"f_mem_contig_float32_load": 208896,
         "f_mem_contig_float32_store": 196608,
         "f_mem_hbm_bytes_in": 835584, "f_mem_hbm_bytes_out": 786432,
         "f_op_float32_madd": 12582912,
         "f_sync_grid_programs": 12, "f_sync_launch_kernel": 1}),
    "dg_diff (1, 32, 512) block_e 512": (
        functools.partial(tops.dg_diff, block_e=512),
        (f32(1, 32, 32), f32(32, 512)),
        {"f_mem_contig_float32_load": 17408,
         "f_mem_contig_float32_store": 16384,
         "f_mem_hbm_bytes_in": 69632, "f_mem_hbm_bytes_out": 65536,
         "f_op_float32_madd": 524288,
         "f_sync_grid_programs": 1, "f_sync_launch_kernel": 1}),
    "dg_diff (3, 64, 262144) block_e 512": (
        functools.partial(tops.dg_diff, block_e=512),
        (f32(3, 64, 64), f32(64, 262144)),
        {"f_mem_contig_float32_load": 50343936,
         "f_mem_contig_float32_store": 50331648,
         "f_mem_hbm_bytes_in": 201375744, "f_mem_hbm_bytes_out": 201326592,
         "f_op_float32_madd": 3221225472,
         "f_sync_grid_programs": 1536, "f_sync_launch_kernel": 1}),
    "stream_strided 2^26 × 2 block 512 stride 1": (
        lambda *a: tops.stream_strided(list(a), block=512, stride=1),
        (f32(2 ** 26), f32(2 ** 26)),
        {"f_mem_contig_float32_load": 134217728,
         "f_mem_contig_float32_store": 67108864,
         "f_mem_hbm_bytes_in": 536870912, "f_mem_hbm_bytes_out": 268435456,
         "f_op_float32_add": 67108864,
         "f_sync_grid_programs": 131072, "f_sync_launch_kernel": 1}),
    "stream_strided 2^26 × 2 block 512 stride 4": (
        lambda *a: tops.stream_strided(list(a), block=512, stride=4),
        (f32(2 ** 26), f32(2 ** 26)),
        {"f_mem_contig_float32_load": 33554432,
         "f_mem_contig_float32_store": 16777216,
         "f_mem_hbm_bytes_in": 134217728, "f_mem_hbm_bytes_out": 67108864,
         "f_op_float32_add": 16777216,
         "f_sync_grid_programs": 32768, "f_sync_launch_kernel": 1}),
    "mamba2_ssd zamba2-7b chunk 256": (
        functools.partial(tops.mamba2_ssd, chunk=256),
        (f32(1, 8192, 112, 64), f32(1, 8192, 112), f32(1, 8192, 112, 64),
         f32(1, 8192, 112, 64)),
        {"f_mem_contig_float32_load": 177078272,
         "f_mem_contig_float32_store": 58720256,
         "f_mem_hbm_bytes_in": 708313088, "f_mem_hbm_bytes_out": 234881024,
         "f_op_float32_add": 310116352, "f_op_float32_madd": 37580963840,
         "f_op_float32_mul": 367001600, "f_op_float32_transc": 236719616,
         "f_sync_grid_programs": 3584, "f_sync_launch_kernel": 1}),
    "mamba2_ssd (2, 128, 4, 32, 16) chunk 32": (
        functools.partial(tops.mamba2_ssd, chunk=32),
        (f32(2, 128, 4, 32), f32(2, 128, 4), f32(2, 128, 4, 16),
         f32(2, 128, 4, 16)),
        {"f_mem_contig_float32_load": 66560,
         "f_mem_contig_float32_store": 32768,
         "f_mem_hbm_bytes_in": 266240, "f_mem_hbm_bytes_out": 131072,
         "f_op_float32_add": 83968, "f_op_float32_madd": 2621440,
         "f_op_float32_mul": 114688, "f_op_float32_transc": 34848,
         "f_sync_grid_programs": 32, "f_sync_launch_kernel": 1}),
    "slstm_cell xlstm-125m (8, 4096, 4, 192)": (
        tops.slstm_cell,
        (f32(8, 4096, 4, 4, 192), f32(4, 192, 4, 192), f32(4, 4, 192)),
        {"f_mem_contig_float32_load": 101256192,
         "f_mem_contig_float32_store": 25165824,
         "f_mem_hbm_bytes_in": 405024768, "f_mem_hbm_bytes_out": 100663296,
         "f_op_float32_add": 528482304, "f_op_float32_cmp": 75497472,
         "f_op_float32_div": 25165824, "f_op_float32_madd": 19327352832,
         "f_op_float32_mul": 100663296, "f_op_float32_transc": 150994944,
         "f_sync_grid_programs": 8, "f_sync_launch_kernel": 1,
         "f_sync_loop_steps": 32768}),
    "slstm_cell (2, 24, 4, 50)": (
        tops.slstm_cell, (f32(2, 24, 4, 4, 50), f32(4, 50, 4, 50),
                          f32(4, 4, 50)),
        {"f_mem_contig_float32_load": 79200,
         "f_mem_contig_float32_store": 9600,
         "f_mem_hbm_bytes_in": 316800, "f_mem_hbm_bytes_out": 38400,
         "f_op_float32_add": 201600, "f_op_float32_cmp": 28800,
         "f_op_float32_div": 9600, "f_op_float32_madd": 1920000,
         "f_op_float32_mul": 38400, "f_op_float32_transc": 57600,
         "f_sync_grid_programs": 2, "f_sync_launch_kernel": 1,
         "f_sync_loop_steps": 48}),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_FEATURES))
def test_cost_rules_keep_the_reference_features(case):
    """Redesigning a CUDA kernel moves only the port's ``f_vmem_*``
    staging term: every feature the reference counts keeps its value."""
    fn, args, want = REFERENCE_FEATURES[case]
    got = count_fn(fn, *args)
    assert {k: v for k, v in got.items()
            if v and not k.startswith("f_vmem_")} == want


@pytest.mark.parametrize("M,N,K,b", [
    (256, 384, 512, 128), (128, 128, 128, 128), (512, 256, 128, 64),
    (192, 320, 80, 16), (4096, 4096, 4096, 256)])
def test_matmul_staging_term_follows_the_kernel_tile(M, N, K, b):
    """One CUDA block per 128 × 128 output tile stages its A rows and B
    columns once, 32 k deep a stage (zero-filled past the matrices),
    whatever the reference's blocks are."""
    bk = min(b, K)
    c = count_fn(functools.partial(tops.matmul, block_m=min(b, M),
                                   block_n=min(b, N), block_k=bk),
                 f32(M, K), f32(K, N))
    tiles = -(-M // 128) * -(-N // 128)
    assert (tmm.TILE, tmm.STAGE_K) == ((128, 128), 32)
    assert c["f_vmem_contig_float32_store"] == \
        tiles * -(-K // 32) * 32 * (128 + 128)


@pytest.mark.parametrize("M,N,K,be", [
    (3, 64, 1024, 256), (1, 32, 512, 512), (3, 64, 262144, 512),
    (3, 64, 250, 250), (5, 8, 3000, 1000), (2, 16, 1536, 512)])
def test_dg_diff_staging_term_follows_the_kernel_slab(M, N, K, be):
    """One CUDA block per slab of 8192 / N elements stages each element
    of ut once (the last slab only its part of K) and every D_m once per
    slab, whatever block_e is."""
    c = count_fn(functools.partial(tops.dg_diff, block_e=be),
                 f32(M, N, N), f32(N, K))
    width = tdg.slab_width(N)
    assert (tdg.SLAB_FLOATS, width * N) == (8192, 8192)
    assert c["f_vmem_contig_float32_store"] == \
        N * K + -(-K // width) * M * N * N


# ---------------------------------------------------------------------------
# dg_diff at any N <= 64: the DG node counts of the paper's §8.4
# ---------------------------------------------------------------------------

DG_NODE_COUNTS = (10, 20, 35, 56)


@pytest.mark.parametrize("N", DG_NODE_COUNTS)
def test_dg_diff_at_dg_node_counts_matches_reference(N):
    """The wrapper takes the tetrahedra's node counts of order 2–5 (on
    the CPU, the plain version) and agrees with the reference kernel."""
    M, K, be = 3, 1024, 256
    (jd, td), (ju, tu) = _both(rn(31, M, N, N), "float32"), \
        _both(rn(32, N, K), "float32")
    want = jops.dg_diff(jd, ju, block_e=be)
    _close(tops.dg_diff(td, tu, block_e=be), want, "float32")


@pytest.mark.parametrize("N,width", [(1, 8), (8, 8), (10, 16), (20, 32),
                                     (35, 64), (56, 64), (64, 64)])
def test_dg_diff_runs_at_the_next_instantiated_width(N, width):
    assert tdg.width(N) == width
    assert tdg.slab_width(N) == tdg.SLAB_FLOATS // width


@pytest.mark.parametrize("N", DG_NODE_COUNTS)
@pytest.mark.parametrize("K,be", [(8192, 512), (262144, 512), (1000, 1000)])
def test_dg_diff_cost_rule_follows_the_launched_grid(N, K, be):
    """The staging term counts one D_m per slab of the grid the kernel
    launches at N: slabs of 8192 / width(N) elements, not 8192 / N."""
    M = 3
    c = count_fn(functools.partial(tops.dg_diff, block_e=be),
                 f32(M, N, N), f32(N, K))
    slabs = -(-K // (8192 // tdg.width(N)))
    assert c["f_vmem_contig_float32_store"] == N * K + slabs * M * N * N
    assert c["f_op_float32_madd"] == M * N * N * K
    assert c["f_sync_grid_programs"] == M * K // be


def test_dg_diff_cuda_raises_only_above_64_and_for_non_f32(monkeypatch):
    """The launcher's own checks: N above 64 and a dtype other than
    float32 raise; N = 10 reaches the launch (recorded here, not run)
    with N itself, no padded copy."""
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="N <= 64"):
        tdg.dg_diff_cuda(torch.ones(1, 65, 65), torch.ones(65, 16), 16)
    with pytest.raises(TypeError, match="float32"):
        tdg.dg_diff_cuda(torch.ones(1, 10, 10, dtype=torch.float64),
                         torch.ones(10, 16, dtype=torch.float64), 16)
    calls = []
    monkeypatch.setattr(_build, "launch_on",
                        lambda dev, name, *a: calls.append((name, a[3:])))
    before = tdg.launches
    out = tdg.dg_diff_cuda(torch.ones(2, 10, 10), torch.ones(10, 16), 16)
    assert calls == [("repro_dg_diff_f32", (2, 10, 16))]
    assert out.shape == (2, 10, 16) and tdg.launches == before + 1
