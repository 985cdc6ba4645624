"""The hand-written CUDA kernels on the card, against their plain
PyTorch versions at the ``tests/test_kernels.py`` shapes and tolerances
(float32 kernels against the plain version evaluated in float64).

Every test here carries the ``gpu`` marker and skips (inside a fixture)
where no card is visible.  The file imports neither jax nor the
reference; skipping the repository's ``conftest.py`` (which imports
jax) lets it run on a machine without jax::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import uipick as tuipick
from repro_torch.kernels import _build
from repro_torch.kernels import dg_diff as tdg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import matmul_tiled as tmm
from repro_torch.kernels import microbench as tmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_cell as tsc
from repro_torch.testing import variants
from repro_torch.testing.variants import (ATTN_KW, ATTN_SHAPES, SLSTM_SHAPES,
                                          SSD_SHAPES)

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


def _reject(got, wrong, *args, dt="float32"):
    """The plain variant ``wrong`` must fail the check ``got`` passed."""
    if dt == "float32":
        args = tuple(x.double() for x in args)
    assert not np.allclose(got.double().cpu().numpy(),
                           wrong(*args).double().cpu().numpy(), **TOL[dt])


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
    # M, N, K not multiples of the kernel's own 128 × 128 tile, its
    # 16-deep slice or its 3-slice ring
    (192, 80, 320, 64, 64, 80),
    (200, 72, 136, 8, 8, 8),
    # N % 4 != 0: B staged element by element, C stored per element
    (96, 40, 90, 32, 30, 40),
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
@pytest.mark.parametrize("N", [1, 10, 20, 35, 56, 63])
@pytest.mark.parametrize("K", [8192, "ragged", 250])
def test_dg_diff_kernel_at_any_node_count_on_card(cuda, N, K):
    """N between the instantiated widths (the DG node counts of
    tetrahedra of order 2–5 among them) runs at the next width, rows and
    columns >= N masked: K = 8192, a ragged last slab, and K = 250 (the
    one-float path)."""
    if K == "ragged":
        K = 2 * tdg.slab_width(N) + 36
    d = torch.from_numpy(rn(17, 3, N, N)).to(cuda)
    ut = torch.from_numpy(rn(18, N, K)).to(cuda)
    before = tdg.launches
    got = tops.dg_diff(d, ut, block_e=K)
    assert tdg.launches == before + 1
    _check(got, tref.dg_diff_ref, d, ut)


@pytest.mark.gpu
def test_stripped_battery_kernel_replays_as_a_cuda_graph(cuda):
    """``remove_work`` of ``matmul_sq`` (prefetch, tile 64) without its
    first operand: captured and replayed as a CUDA graph, it returns the
    sum of b, fresh on every call."""
    from repro_torch.core.workremoval import remove_work

    (kern,) = tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
        .generate_kernels(["matmul_sq", "n:256", "dtype:float32",
                           "prefetch:True", "tile:64"])
    args = kern.make_args(cuda)
    stripped = remove_work(kern.fn, *args, remove_args=(0,))
    want = float(args[1].double().sum())
    graph, out = tuipick.MeasurementKernel(
        name="stripped", fn=stripped, make_args=kern.make_args,
        tags={}).capture(args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert float(out) == pytest.approx(want, abs=1e-5 * float(
            args[1].abs().sum()))


def _unaligned(x: np.ndarray, dev) -> torch.Tensor:
    """``x`` on the card, contiguous, one float past a 16-byte boundary."""
    t = torch.empty(x.size + 1, device=dev)[1:].view(x.shape)
    t.copy_(torch.from_numpy(x))
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 3, 5])
@pytest.mark.parametrize("N", [8, 16, 32, 64])
@pytest.mark.parametrize("K", ["ragged", 250])
def test_dg_diff_kernel_edges_on_card(cuda, M, N, K):
    """K not a multiple of the kernel's slab (the last slab masked, K % 4
    == 0), and K = 250 with block_e 250 (rows not 16-byte aligned: the
    one-float path)."""
    if K == "ragged":
        K = 2 * tdg.slab_width(N) + 36
    d = torch.from_numpy(rn(13, M, N, N)).to(cuda)
    ut = torch.from_numpy(rn(14, N, K)).to(cuda)
    before = tdg.launches
    got = tops.dg_diff(d, ut, block_e=K)
    assert tdg.launches == before + 1
    _check(got, tref.dg_diff_ref, d, ut)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["d", "ut"])
def test_dg_diff_kernel_on_unaligned_operands(cuda, which):
    """A contiguous operand whose pointer is not 16-byte aligned takes the
    one-float path."""
    M, N, K = 3, 64, 1024
    d, ut = rn(15, M, N, N), rn(16, N, K)
    d = _unaligned(d, cuda) if which == "d" else torch.from_numpy(d).to(cuda)
    ut = _unaligned(ut, cuda) if which == "ut" else \
        torch.from_numpy(ut).to(cuda)
    _check(tops.dg_diff(d, ut, block_e=256), tref.dg_diff_ref, d, ut)


@pytest.mark.gpu
def test_cuda_path_raises_on_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        tops.stencil5(torch.ones(64, 64, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        tops.matmul(torch.ones(64, 128, device=cuda).T,
                    torch.ones(64, 64, device=cuda))
    with pytest.raises(TypeError):
        tops.madd_throughput(torch.ones(1024, dtype=torch.bfloat16,
                                        device=cuda))
    with pytest.raises(TypeError):
        tops.flash_attention(*[torch.ones(1, 64, 2, 16, device=cuda,
                                          dtype=torch.float64)] * 3)
    with pytest.raises(ValueError):
        tops.flash_attention(torch.ones(1, 64, 2, 512, device=cuda),
                             *[torch.ones(1, 64, 1, 512, device=cuda)] * 2)
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(*[torch.ones(1, 64, 2, 16, device=cuda)] * 3,
                             window=-1)
    with pytest.raises(ValueError):
        tops.mamba2_ssd(torch.ones(1, 64, 2, 128, device=cuda),
                        torch.ones(1, 64, 2, device=cuda),
                        *[torch.ones(1, 64, 2, 16, device=cuda)] * 2)
    with pytest.raises(TypeError):
        tops.slstm_cell(torch.ones(1, 4, 4, 2, 8, device=cuda,
                                   dtype=torch.bfloat16),
                        torch.ones(2, 8, 4, 8, device=cuda,
                                   dtype=torch.bfloat16),
                        torch.ones(4, 2, 8, device=cuda,
                                   dtype=torch.bfloat16))
    # more than 8 inputs take one launch per group of 8
    before = tmb.launches["stream_strided"]
    out = tops.stream_strided([torch.ones(1024, device=cuda)] * 9, block=256)
    assert tmb.launches["stream_strided"] == before + 2
    assert bool((out == 9).all())


@pytest.mark.gpu
def test_raw_stream_is_the_current_stream(cuda):
    """The wrappers launch on the stream of a private torch call
    (``torch._C._cuda_getCurrentRawStream`` in ``_build.launch_on``): it
    must be the public current stream, on a side stream too, and a kernel
    launched there must run on it."""
    idx = torch.cuda.current_device()
    raw = torch._C._cuda_getCurrentRawStream
    assert raw(idx) == torch.cuda.current_stream(idx).cuda_stream
    side = torch.cuda.Stream(cuda)
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        assert raw(idx) == side.cuda_stream != torch.cuda.default_stream(
            idx).cuda_stream
        out = tops.stream_strided([x, x], block=512)
    side.synchronize()
    assert bool((out == 2).all())


@pytest.mark.gpu
@pytest.mark.parametrize("S,block,stride,n_arrays", [
    (8192, 256, 1, 1), (8192, 256, 2, 1), (8192, 256, 4, 1),
    (8192, 256, 1, 3), (8192, 256, 2, 3), (8192, 256, 4, 3),
    (8000, 250, 2, 3),          # block % 4 != 0: the one-float path
    # more inputs than one launch sums: groups of 8, in order
    (8192, 256, 1, 9), (8192, 256, 2, 17), (8000, 250, 2, 9),
])
def test_stream_strided_kernel_on_card(cuda, S, block, stride, n_arrays):
    arrs = [torch.from_numpy(rn(20 + j, S)).to(cuda)
            for j in range(n_arrays)]
    before = tmb.launches["stream_strided"]
    got = tops.stream_strided(arrs, block=block, stride=stride)
    assert tmb.launches["stream_strided"] == before + -(-n_arrays // 8)
    _check(got, lambda *a: tref.stream_ref(list(a), block=block,
                                           stride=stride), *arrs)


@pytest.mark.gpu
@pytest.mark.parametrize("S,block,stride,n_arrays,aligned", [
    # inputs one float past a 16-byte boundary: the one-float path
    (8192, 256, 1, 2, False), (8192, 256, 4, 3, False),
    (8192, 256, 2, 9, False), (8192, 256, 1, 17, False),
    # block % 4 == 0 but not a multiple of a thread's 4 outputs or of a
    # CUDA block's 1024: output blocks straddle threads and CUDA blocks,
    # the last CUDA block ragged
    (12000, 12, 1, 2, True), (20640, 516, 4, 3, True),
    (12 * 3 * 700, 12, 3, 9, True), (516 * 2 * 40, 516, 2, 17, True),
])
def test_stream_strided_kernel_edges_on_card(cuda, S, block, stride,
                                             n_arrays, aligned):
    arrs = [rn(40 + j, S) for j in range(n_arrays)]
    arrs = [torch.from_numpy(a).to(cuda) if aligned else _unaligned(a, cuda)
            for a in arrs]
    before = tmb.launches["stream_strided"]
    got = tops.stream_strided(arrs, block=block, stride=stride)
    assert tmb.launches["stream_strided"] == before + -(-n_arrays // 8)
    _check(got, lambda *a: tref.stream_ref(list(a), block=block,
                                           stride=stride), *arrs)


@pytest.mark.gpu
@pytest.mark.parametrize("S,iters,block", [
    (4096, 32, 1024), (4000, 32, 1000), (4096, 7, 4096)])
def test_madd_throughput_kernel_on_card(cuda, S, iters, block):
    x = torch.from_numpy(rn(30, S)).to(cuda)
    before = tmb.launches["madd_throughput"]
    got = tops.madd_throughput(x, iters=iters, block=block)
    assert tmb.launches["madd_throughput"] == before + 1
    _check(got, lambda v: tref.madd_ref(v, iters=iters), x)


@pytest.mark.gpu
@pytest.mark.parametrize("S,iters,block", [
    (4096, 32, 1024), (4000, 32, 1000), (2 ** 20, 256, 2048)])
def test_madd_throughput_chain_visible_on_card(cuda, S, iters, block):
    """With a = 0.999, b = 0.01 every step moves the output far beyond
    the tolerance (the reference's a and b move it ~2e-4 of itself over
    256 steps), so a kernel that skips steps fails here."""
    visible = dict(a=0.999, b=0.01)
    x = torch.from_numpy(rn(31, S)).to(cuda)
    got = tops.madd_throughput(x, iters=iters, block=block, **visible)
    _check(got, lambda v: tref.madd_ref(v, iters=iters, **visible), x)
    want = tref.madd_ref(x.double(), iters=iters, **visible)
    room = TOL["float32"]["atol"] + TOL["float32"]["rtol"] * want.abs()
    for short in (iters // 2, 0):
        wrong = tref.madd_ref(x.double(), iters=short, **visible)
        assert bool(((wrong - want).abs() > room).all())


def _attention_inputs(dev, dt, B, S, Hq, Hkv, D, q_scale=1.0):
    tdt = DTYPES[dt]
    return (torch.from_numpy(rn(3, B, S, Hq, D) * q_scale).to(dev, tdt),
            torch.from_numpy(rn(4, B, S, Hkv, D)).to(dev, tdt),
            torch.from_numpy(rn(5, B, S, Hkv, D)).to(dev, tdt))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
def test_flash_attention_kernel_on_card(cuda, dt, kw, B, S, Hq, Hkv, D):
    q, k, v = _attention_inputs(cuda, dt, B, S, Hq, Hkv, D)
    before = tfa.launches
    got = tops.flash_attention(q, k, v, block_q=64, block_k=64, **kw)
    assert tfa.launches == before + 1
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
def test_flash_attention_check_rejects_wrong_variants(cuda, dt, kw, B, S,
                                                      Hq, Hkv, D):
    """With q scaled by 8 the scores reach tens (unit inputs move them by
    ~1e-4 of themselves under softcap 50): the kernel passes, and the
    plain version without the softcap, without the window, or with the kv
    head h % Hkv fails wherever it computes something different."""
    q, k, v = _attention_inputs(cuda, dt, B, S, Hq, Hkv, D, q_scale=8.0)
    got = tops.flash_attention(q, k, v, block_q=64, block_k=64, **kw)
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v, dt=dt)
    for _, wrong in variants.attention_variants_for(kw, Hq, Hkv):
        _reject(got, wrong, q, k, v, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,D,Dv,kw", [
    # gemma's D = 256: a window inside one kv tile, and one that starts
    # mid-sequence, so kv tiles are skipped below the window and above
    # the diagonal
    (512, 512, 256, 256, dict(causal=True, window=24)),
    (512, 512, 256, 256, dict(causal=True, window=160, softcap=50.0)),
    # a window without causal keeps every later key
    (512, 512, 256, 256, dict(causal=False, window=100)),
    # D not a multiple of 16: 16-byte staging (40), element staging (20),
    # an odd Dv (stored element by element)
    (256, 256, 40, 40, dict(causal=True)),
    (256, 256, 20, 20, dict(causal=True, window=48)),
    (128, 128, 48, 33, dict(causal=True, softcap=30.0)),
    # Sq not a multiple of the kernel's query tile (128 bf16, 64 f32),
    # and a ragged last kv tile
    (160, 160, 64, 64, dict(causal=True)),
    (96, 96, 128, 128, dict(causal=False, softcap=30.0)),
    (96, 160, 64, 64, dict(causal=True, window=40)),
    # zamba2-7b's D = 112 (TMA zero fills the slab past it), deepseek's
    # Dk 192 / Dv 128 with Sq != Skv, and a window inside one kv tile
    (160, 160, 112, 112, dict(causal=True)),
    (96, 160, 192, 128, dict(causal=False)),
    (192, 192, 112, 112, dict(causal=True, window=10, softcap=30.0)),
])
def test_flash_attention_kernel_edges_on_card(cuda, dt, Sq, Skv, D, Dv, kw):
    """The tile skip, the padding of D and the ragged edges: q × 8 (scores
    in the tens), the plain version at the reference tolerance, and each
    plain variant that drops the window, the softcap or the GQA head map
    fails."""
    tdt = DTYPES[dt]
    B, Hq, Hkv = 1, 4, 2
    q = torch.from_numpy(rn(40, B, Sq, Hq, D) * 8.0).to(cuda, tdt)
    k = torch.from_numpy(rn(41, B, Skv, Hkv, D)).to(cuda, tdt)
    v = torch.from_numpy(rn(42, B, Skv, Hkv, Dv)).to(cuda, tdt)
    before = tfa.launches
    got = tops.flash_attention(q, k, v, block_q=32, block_k=32, **kw)
    assert tfa.launches == before + 1
    assert got.shape == (B, Sq, Hq, Dv)
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v, dt=dt)
    for _, wrong in variants.attention_variants_for(kw, Hq, Hkv):
        _reject(got, wrong, q, k, v, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,B,Sq,Skv,Hq,Hkv,D,Dv,kw", [
    (dt, *case[1:]) for case in variants.ATTN_SERVED_CASES
    for dt in case[0]])
def test_flash_attention_served_shapes_on_card(cuda, dt, B, Sq, Skv, Hq,
                                               Hkv, D, Dv, kw):
    """The served models' GQA groups 6 and 7 (Hq 12 and 14 on 2 kv heads)
    and whisper-tiny's f32 cross-attention (Sq 224 on 1500 keys, a
    ragged last kv tile): q × 8, the plain version at the reference
    tolerance, the call on the route ``route`` names, and each plain
    variant (the head map h % Hkv, the ragged tile skipped) fails."""
    tdt = DTYPES[dt]
    q = torch.from_numpy(rn(60, B, Sq, Hq, D) * 8.0).to(cuda, tdt)
    k = torch.from_numpy(rn(61, B, Skv, Hkv, D)).to(cuda, tdt)
    v = torch.from_numpy(rn(62, B, Skv, Hkv, Dv)).to(cuda, tdt)
    before, routes = tfa.launches, tfa.routes()
    got = tops.flash_attention(q, k, v, block_q=Sq, block_k=Skv, **kw)
    assert tfa.launches == before + 1
    taken = {r: n - routes[r] for r, n in tfa.routes().items()}
    assert taken == {r: int(r == tfa.route(tdt, D, Dv)) for r in taken}
    assert got.shape == (B, Sq, Hq, Dv)
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v, dt=dt)
    wrongs = variants.attention_variants_for(kw, Hq, Hkv, Skv)
    assert wrongs
    for _, wrong in wrongs:
        _reject(got, wrong, q, k, v, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,D,Dv,offset", [
    ("bfloat16", 256, 256, 0), ("bfloat16", 112, 112, 0),
    ("bfloat16", 192, 128, 0), ("bfloat16", 8, 8, 0),
    ("bfloat16", 64, 64, 1), ("bfloat16", 100, 60, 0),
    ("bfloat16", 20, 20, 0), ("float32", 112, 112, 0)])
def test_flash_attention_forward_route_on_card(cuda, dt, D, Dv, offset):
    """The forward takes the route ``route`` says, by the kernel's own
    counters: aligned bf16 with D and Dv multiples of 8 the wgmma route,
    a view one element off a 16-byte boundary (``offset``) or Dk 100 /
    Dv 60 mma.sync, f32 FMA; each gives the plain version's output."""
    tdt = DTYPES[dt]
    B, S, Hq, Hkv = 1, 160, 4, 2

    def on_card(seed, *shape, factor=1.0):
        flat = torch.from_numpy(rn(seed, int(np.prod(shape)) + offset)
                                * factor)
        return flat.to(cuda, tdt)[offset:].view(*shape)

    q = on_card(80, B, S, Hq, D, factor=8.0)
    k, v = on_card(81, B, S, Hkv, D), on_card(82, B, S, Hkv, Dv)
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    kw = dict(causal=True, window=48, softcap=30.0)
    before = tfa.routes()
    got = tops.flash_attention(q, k, v, block_q=32, block_k=32, **kw)
    taken = {r: n - before[r] for r, n in tfa.routes().items()}
    route = tfa.route(tdt, D, Dv, aligned=not offset)
    assert taken == {r: int(r == route) for r in taken}
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v, dt=dt)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
def test_flash_attention_mma_route_on_card(cuda, kw, B, S, Hq, Hkv, D):
    """The mma.sync route at the shapes the wgmma route now takes
    (``flash_attention_mma_cuda``): q × 8, the plain version passes and
    every plain variant fails, as before the wgmma route; it counts as
    mma_sync and not as a launch of the model path."""
    q, k, v = _attention_inputs(cuda, "bfloat16", B, S, Hq, Hkv, D,
                                q_scale=8.0)
    before, launches = tfa.routes(), tfa.launches
    got = tfa.flash_attention_mma_cuda(
        q, k, v, kw.get("causal", True), kw.get("window"),
        kw.get("softcap"), D ** -0.5)
    taken = {r: n - before[r] for r, n in tfa.routes().items()}
    assert taken == {"wgmma": 0, "mma_sync": 1, "fma": 0}
    assert tfa.launches == launches
    _check(got, lambda *a: tref.attention_ref(*a, **kw), q, k, v,
           dt="bfloat16")
    for _, wrong in variants.attention_variants_for(kw, Hq, Hkv):
        _reject(got, wrong, q, k, v, dt="bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 112, 256])
def test_flash_attention_forward_is_bit_for_bit_repeatable(cuda, D):
    """No atomics on the wgmma route: forward runs (and their lse) on the
    same inputs agree bit for bit, at each ring depth (four stages at D
    64 and 112, two at 256)."""
    q, k, v = _attention_inputs(cuda, "bfloat16", 2, 320, 8, 2, D,
                                q_scale=8.0)
    args = (True, 100, 50.0, D ** -0.5)
    before = tfa.routes()["wgmma"]
    first = tfa.flash_attention_lse_cuda(q, k, v, *args)
    for _ in range(3):
        again = tfa.flash_attention_lse_cuda(q, k, v, *args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert tfa.routes()["wgmma"] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Skv,D,kw", [
    (256, 256, 112, dict(causal=True, window=40, softcap=30.0)),
    (256, 256, 256, dict(causal=True)),
    # rows 95.. see no key: the second query tile visits no kv tile, the
    # first's rows 95..127 only masked ones
    (256, 64, 64, dict(causal=True, window=32)),
    # no row sees a key (causal, window 0): no kv tile at all
    (192, 192, 64, dict(causal=True, window=0)),
])
def test_flash_attention_lse_on_the_wgmma_route(cuda, Sq, Skv, D, kw):
    """The wgmma route's lse: each row's log-sum-exp of its scaled,
    capped, masked scores; rows that see no key give output 0 and lse
    about -1e30, as the mma.sync route does."""
    B, Hq, Hkv = 1, 4, 2
    q = torch.from_numpy(rn(90, B, Sq, Hq, D) * 8.0).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rn(91, B, Skv, Hkv, D)).to(cuda, torch.bfloat16)
    v = torch.from_numpy(rn(92, B, Skv, Hkv, D)).to(cuda, torch.bfloat16)
    scale, cap, window = D ** -0.5, kw.get("softcap"), kw.get("window")
    before = tfa.routes()["wgmma"]
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, True, window, cap,
                                            scale)
    assert tfa.routes()["wgmma"] == before + 1
    qd, kd = q.double(), k.double().repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    i, j = torch.arange(Sq, device=cuda), torch.arange(Skv, device=cuda)
    mask = i[:, None] >= j[None]
    if window is not None:
        mask &= i[:, None] - j[None] < window
    sees = mask.any(dim=-1)
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    seen = (lse.double() - want)[..., sees]
    assert seen.numel() == 0 or float(seen.abs().max()) < 1e-4
    assert bool((lse[..., ~sees] < -1e29).all())
    assert bool((out[:, ~sees] == 0).all())
    # the plain version's rows that see no key are NaN (a softmax of -inf
    # alone): it is held on the others
    _check(out[:, sees],
           lambda *a: tref.attention_ref(*a, scale=scale, **kw)[:, sees],
           q, k, v, dt="bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 128, 192, 256])
def test_wgmma_pv_tile_on_card(cuda, n):
    """The forward's P as the register A operand: bf16(q·kᵀ)·v from one
    warpgroup, the chain the wgmma route runs each kv tile, against the
    plain version — bit for bit on integer inputs in {-1, 0, 1} (every
    step exact, so a fragment out of place shows), and on unit normal
    inputs within f32 summation order of the same bf16 P."""
    rng = np.random.default_rng(n)
    ints = [torch.from_numpy(rng.integers(-1, 2, shape).astype(np.float32))
            .to(cuda, torch.bfloat16) for shape in ((64, 256), (64, 256),
                                                    (64, n))]
    got = tfa.wgmma_pv_tile(*ints)
    assert torch.equal(got, tfa.wgmma_pv_tile(*(t.cpu() for t in ints))
                       .to(cuda))
    q = torch.from_numpy(rn(93, 64, 256) / 16).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rn(94, 64, 256)).to(cuda, torch.bfloat16)
    v = torch.from_numpy(rn(95, 64, n)).to(cuda, torch.bfloat16)
    got = tfa.wgmma_pv_tile(q, k, v)
    s = q.float() @ k.float().T
    p = s.to(torch.bfloat16).float()
    # the card's score sums may round to the neighbouring bf16 value
    # where the exact sum lies near a rounding boundary
    slack = (s.abs() * 2.0 ** -8).clamp(min=1e-6) @ v.float().abs()
    assert bool(((got - p @ v.float()).abs() <= 1e-4 + slack).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_mamba2_ssd_kernel_on_card(cuda, B, S, H, P, N, chunk):
    xdt = torch.from_numpy(rn(6, B, S, H, P)).to(cuda)
    da = torch.from_numpy(-np.abs(rn(7, B, S, H)) * 0.1).to(cuda)
    bm = torch.from_numpy(rn(8, B, S, H, N)).to(cuda)
    cm = torch.from_numpy(rn(9, B, S, H, N)).to(cuda)
    before = tssd.launches
    got = tops.mamba2_ssd(xdt, da, bm, cm, chunk=chunk)
    assert tssd.launches == before + 1
    _check(got, tref.ssd_ref, xdt, da, bm, cm)
    # S > chunk: a kernel that drops the carried state, or takes it one
    # chunk late, fails
    for wrong in (variants.ssd_without_carried_state,
                  variants.ssd_state_one_chunk_late):
        _reject(got, lambda *a: wrong(*a, chunk=chunk), xdt, da, bm, cm)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    # P and N not multiples of 4 (4-byte staging), kernel chunks shorter
    # than the 64-row tile (48, 50), and caller chunks the kernel splits
    # (96 → 48, 128 and 256 → 64)
    (1, 192, 2, 6, 5, 96), (2, 100, 3, 64, 64, 50), (1, 256, 2, 64, 64, 128),
    (1, 512, 2, 64, 64, 256), (1, 64, 1, 1, 1, 64)])
def test_mamba2_ssd_kernel_edges_on_card(cuda, B, S, H, P, N, chunk):
    xdt = torch.from_numpy(rn(16, B, S, H, P)).to(cuda)
    da = torch.from_numpy(-np.abs(rn(17, B, S, H)) * 0.1).to(cuda)
    bm = torch.from_numpy(rn(18, B, S, H, N)).to(cuda)
    cm = torch.from_numpy(rn(19, B, S, H, N)).to(cuda)
    got = tops.mamba2_ssd(xdt, da, bm, cm, chunk=chunk)
    args = tuple(t.double() for t in (xdt, da, bm, cm))
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               tref.ssd_ref(*args).cpu().numpy(),
                               **TOL["float32"])
    # the state one of the kernel's own chunks late fails the check
    if S > tssd.inner_chunk(chunk):
        late = variants.ssd_state_one_chunk_late(
            *args, chunk=tssd.inner_chunk(chunk))
        assert not np.allclose(got.double().cpu().numpy(),
                               late.cpu().numpy(), **TOL["float32"])
    # the three passes launched one by one compute the same output
    out, calls = tssd.pass_calls(xdt, da, bm, cm, chunk)
    assert [name for name, _ in calls] == list(tssd.PASSES)
    for _, launch in calls:
        launch()
    torch.testing.assert_close(out, got, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES + [
    # a prefill padded to the chunk (the padded steps are exact no-ops),
    # zamba2-7b's head widths, a caller chunk the kernel splits
    (1, 256, 3, 64, 64, 256), (2, 100, 2, 6, 5, 50)])
def test_mamba2_ssd_state_kernel_on_card(cuda, B, S, H, P, N, chunk):
    """The final state from pass (b)'s extra slot, and y unchanged."""
    xdt = torch.from_numpy(rn(26, B, S, H, P)).to(cuda)
    da = torch.from_numpy(-np.abs(rn(27, B, S, H)) * 0.1).to(cuda)
    bm = torch.from_numpy(rn(28, B, S, H, N)).to(cuda)
    cm = torch.from_numpy(rn(29, B, S, H, N)).to(cuda)
    before = tssd.launches
    y, state = tops.mamba2_ssd_state(xdt, da, bm, cm, chunk=chunk)
    assert tssd.launches == before + 1
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    want_y, want_state = tref.ssd_state_ref(
        *(t.double() for t in (xdt, da, bm, cm)))
    np.testing.assert_allclose(y.double().cpu().numpy(),
                               want_y.cpu().numpy(), **TOL["float32"])
    np.testing.assert_allclose(state.double().cpu().numpy(),
                               want_state.cpu().numpy(), **TOL["float32"])
    # the state before the last step is not the state after it
    _, early = tref.ssd_state_ref(
        *(t[:, :-1].double() for t in (xdt, da, bm, cm)))
    assert not np.allclose(state.double().cpu().numpy(),
                           early.cpu().numpy(), **TOL["float32"])
    torch.testing.assert_close(y, tops.mamba2_ssd(xdt, da, bm, cm,
                                                  chunk=chunk),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES + [(9, 12, 2, 192),
                                                     (2, 12, 2, 200)])
def test_slstm_cell_state_kernel_on_card(cuda, B, S, H, dh):
    """c, n, m after the last step from the gating threads (one and two
    batch rows a cluster, clusters of 6 and 8), and h unchanged."""
    g_in = torch.from_numpy(rn(56, B, S, 4, H, dh) * 0.5).to(cuda)
    r = torch.from_numpy(rn(57, H, dh, 4, dh) * 0.1).to(cuda)
    b = torch.from_numpy(rn(58, 4, H, dh) * 0.1).to(cuda)
    before = tsc.launches
    h, (c, n, m) = tops.slstm_cell_state(g_in, r, b)
    assert tsc.launches == before + 1
    want_h, want = tref.slstm_cell_state_ref(g_in.double(), r.double(),
                                             b.double())
    np.testing.assert_allclose(h.double().cpu().numpy(),
                               want_h.cpu().numpy(), **TOL["float32"])
    for got, w in zip((c, n, m), want):
        assert got.shape == (B, H, dh)
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   w.cpu().numpy(), **TOL["float32"])
    torch.testing.assert_close(h, tops.slstm_cell(g_in, r, b), rtol=0,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh", SLSTM_SHAPES)
def test_slstm_cell_kernel_on_card(cuda, B, S, H, dh):
    g_in = torch.from_numpy(rn(50, B, S, 4, H, dh) * 0.5).to(cuda)
    r = torch.from_numpy(rn(51, H, dh, 4, dh) * 0.1).to(cuda)
    b = torch.from_numpy(rn(52, 4, H, dh) * 0.1).to(cuda)
    before = tsc.launches
    got = tops.slstm_cell(g_in, r, b)
    assert tsc.launches == before + 1
    _check(got, tref.slstm_cell_ref, g_in, r, b)
    _reject(got, variants.slstm_without_recurrence, g_in, r, b)
    _reject(got, variants.slstm_peer_h_stale, g_in, r, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh", [
    # one unit (the step-latency floor's width), dh > 192 (clusters of 8),
    # the largest dh, and B·H = 18 clusters of xlstm-125m's width, more
    # than an H100 holds at once (17), with B odd: two rows a cluster
    (1, 32, 1, 4), (2, 12, 2, 200), (1, 8, 1, 256), (9, 12, 2, 192)])
def test_slstm_cell_cluster_plans_on_card(cuda, B, S, H, dh):
    g_in = torch.from_numpy(rn(53, B, S, 4, H, dh) * 0.5).to(cuda)
    r = torch.from_numpy(rn(54, H, dh, 4, dh) * 0.1).to(cuda)
    b = torch.from_numpy(rn(55, 4, H, dh) * 0.1).to(cuda)
    got = tops.slstm_cell(g_in, r, b)
    plan = tsc.plans[(g_in.device, B, H, dh)]
    assert plan["cluster_blocks"] == tsc.cluster_blocks(dh)
    assert plan["max_active_clusters"] > 0
    assert plan["rows_per_cluster"] == \
        (1 if B * H <= plan["max_active_clusters"] else 2)
    _check(got, tref.slstm_cell_ref, g_in, r, b)
    _reject(got, variants.slstm_peer_h_stale, g_in, r, b)
    # the kernel is built for the caller's two cluster sizes only: any
    # other size is refused, not run
    for cs in (4, 14 - tsc.cluster_blocks(dh)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch_on(
                g_in.device, "repro_slstm_cell_f32", g_in.data_ptr(), r.data_ptr(),
                b.data_ptr(), got.data_ptr(), 0, 0, B, S, H, dh, cs, 1)


def _default_battery():
    from repro_torch.profiles.presets import CALIBRATION_TAGS
    return tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
        .generate_kernels(CALIBRATION_TAGS, tuipick.MatchCondition.INTERSECT)


@pytest.mark.gpu
def test_graph_replay_equals_eager_on_default_battery(cuda):
    """Battery timing replays one captured CUDA graph per kernel; the
    replay must compute what the eager call computes."""
    kernels = _default_battery()
    assert len(kernels) == 43
    for k in kernels:
        args = k.make_args(cuda)
        eager = k.fn(*args)
        graph, out = k.capture(args)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, eager, msg=k.name)
        del graph, out, eager, args


@pytest.mark.gpu
def test_graph_replay_equals_eager_on_the_loop_and_figure_kernels(cuda):
    """The five generators ported last, at the sizes the paper's figures
    time them (and the shortest ``onchip`` and ``sync_loop`` loops): a
    loop is captured launch by launch, and the replay computes what the
    eager call computes."""
    from repro_torch.studies import paper_figures as pf
    kernels = [k for tags in (pf.FIG5_TAGS, pf.FIG8_TAGS, pf.FIG9_TAGS,
                              ["onchip_pattern", "iters:64"],
                              ["sync_loop_pattern", "steps:64,32768"])
               for k in pf.kernels(tags)]
    assert len(kernels) == 7 + 8 + 4 + 3 + 2
    for k in kernels:
        args = k.make_args(cuda)
        eager = k.fn(*args)
        graph, out = k.capture(args)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, eager, msg=k.name)
        del graph, out, eager, args


@pytest.mark.gpu
def test_section8_tune_and_warm_retune_on_card(cuda, tmp_path):
    """The three §8 spaces priced by an exact synthetic fit and confirmed
    on the card (one CUDA-graph timing per space at margin 0), then a
    fresh session over the saved profile re-tunes from the record with
    zero timings, zero counting passes and zero evaluations."""
    from repro_torch.api.session import PerfSession
    from repro_torch.profiles.profile import save_profile
    from repro_torch.testing.synthdev import exact_profile, fleet_device
    from repro_torch.tuning import section8_spaces, tune_space

    session = PerfSession.open(exact_profile(fleet_device("citra")))
    for space in section8_spaces():
        res = tune_space(session, space, margin=0.0, trials=3)
        assert not res.warm and res.timings_performed == 1, space.name
        assert 0.0 < res.choice.measured_s < 1.0, space.name
    path = save_profile(session.profile, tmp_path / "tuned.json")
    warm = PerfSession.open(path)
    assert all(tune_space(warm, space).warm for space in section8_spaces())
    assert (warm.timer.calls, warm.engine.trace_count,
            warm.eval_calls) == (0, 0, 0)


@pytest.mark.gpu
def test_daemon_serves_a_card_profile_without_timing_or_launching(cuda):
    """A profile calibrated on the card (the smoke study tags, 2 trials)
    served by a ``PredictionDaemon``: a held 16-request burst over the
    eight hand-kernel targets (``meta`` tensors) is one batched
    evaluation with zero timings and no hand-kernel launch."""
    import json
    import time
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.api.session import PerfSession
    from repro_torch.kernels import stencil5
    from repro_torch.serving import PredictionDaemon
    from repro_torch.studies.zoo import STUDY_SMOKE_TAGS

    calibrated = PerfSession.open(None, tags=STUDY_SMOKE_TAGS, trials=2)
    assert calibrated.timer.calls > 0
    session = PerfSession.open(calibrated.profile)
    modules = (tmm, tfa, tssd, tsc, tdg, stencil5)
    for m in modules:
        m.launches = 0
    for name in tmb.launches:
        tmb.launches[name] = 0
    d = PredictionDaemon(session, port=0, max_wait_s=0.001).start()
    try:
        names = sorted(d.targets)
        assert len(names) == 8
        d.batcher.hold()

        def post(name):
            req = urllib.request.Request(
                f"{d.url}/predict", method="POST",
                data=json.dumps({"kernel": name}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())

        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(post, names[i % 8]) for i in range(16)]
            deadline = time.monotonic() + 30.0
            while d.batcher.pending_count() < 16:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            d.batcher.release()
            replies = [f.result(timeout=60) for f in futs]
        stats = d.stats()
    finally:
        d.close()
    assert all(s == 200 and b["seconds"] > 0 for s, b in replies)
    assert stats["timings"] == 0 and stats["eval_calls"] == 1
    assert stats["count_lookups"] == 8
    assert [m.launches for m in modules] == [0] * len(modules)
    assert not any(tmb.launches.values())


# ---------------------------------------------------------------------------
# the attention backward kernel (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------


def _hold_gradients(got, want, dt):
    """f32: each of dq, dk, dv within 1e-4 × its max |g| of the float64
    vjp; bf16: within 1e-2 of each element plus 2e-2 × its row's rms plus
    1e-4 × max |g| (chip_smoke.py phase 16's form)."""
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        diff = (g - w).abs()
        scale = float(w.abs().max())
        if dt == "float32":
            assert float(diff.max()) <= 1e-4 * scale
        else:
            rms = w.square().mean(dim=-1, keepdim=True).sqrt()
            assert bool((diff <= 1e-2 * w.abs() + 2e-2 * rms
                         + 1e-4 * scale).all())


def _attention_grads_on_card(q, k, v, dout, kw, block_q, block_k):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.launches, tfa.backward_launches)
    out = tops.flash_attention(*leaves, block_q=block_q, block_k=block_k,
                               **kw)
    got = torch.autograd.grad(out, leaves, dout)
    assert (tfa.launches, tfa.backward_launches) == (before[0] + 1,
                                                     before[1] + 1)
    wide = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.attention_ref(*wide, **kw), wide,
                               dout.double())
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN_KW)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
def test_flash_attention_backward_kernel_on_card(cuda, dt, kw, B, S, Hq,
                                                 Hkv, D):
    """Under autograd ``ops.flash_attention`` on the card runs the
    forward kernel keeping lse and, in backward, the backward kernel (one
    launch of each); dq, dk and dv against the plain version's autograd
    in float64, q × 8 so the softcap bites."""
    q, k, v = _attention_inputs(cuda, dt, B, S, Hq, Hkv, D, q_scale=8.0)
    dout = torch.from_numpy(rn(30, B, S, Hq, D)).to(cuda, DTYPES[dt])
    got, want = _attention_grads_on_card(q, k, v, dout, kw, 64, 64)
    _hold_gradients(got, want, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,D,Dv,kw", [
    (512, 512, 256, 256, dict(causal=True, window=24, softcap=50.0)),
    (512, 512, 256, 256, dict(causal=False, window=100)),
    (256, 256, 40, 40, dict(causal=True)),
    (256, 256, 20, 20, dict(causal=True, window=48)),
    (128, 128, 48, 33, dict(causal=True, softcap=30.0)),
    (160, 160, 64, 64, dict(causal=True)),
    (96, 160, 192, 128, dict(causal=False)),
    (96, 160, 64, 64, dict(causal=True, window=40)),
    (130, 100, 64, 64, dict(causal=True)),
])
def test_flash_attention_backward_kernel_edges_on_card(cuda, dt, Sq, Skv, D,
                                                       Dv, kw):
    """The backward's tiles at ragged edges, padded head dims, Dk ≠ Dv,
    Sq ≠ Skv (keys no query sees get zero dk and dv), and the window
    without causal."""
    tdt = DTYPES[dt]
    B, Hq, Hkv = 1, 4, 2
    q = torch.from_numpy(rn(50, B, Sq, Hq, D) * 8.0).to(cuda, tdt)
    k = torch.from_numpy(rn(51, B, Skv, Hkv, D)).to(cuda, tdt)
    v = torch.from_numpy(rn(52, B, Skv, Hkv, Dv)).to(cuda, tdt)
    dout = torch.from_numpy(rn(53, B, Sq, Hq, Dv)).to(cuda, tdt)
    got, want = _attention_grads_on_card(q, k, v, dout, kw, Sq, Skv)
    _hold_gradients(got, want, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,B,Sq,Skv,Hq,Hkv,D,Dv,kw", [
    (dt, *case[1:]) for case in variants.ATTN_BWD_TRAINED_CASES
    for dt in case[0]])
def test_flash_attention_backward_trained_shapes_on_card(cuda, dt, B, Sq,
                                                         Skv, Hq, Hkv, D, Dv,
                                                         kw):
    """The trained models' backward shapes: GQA groups 4, 6 and 7 at D
    128 (the dK/dV passes sum a kv head's gradient over its group),
    deepseek-v2's MLA causal, whisper-tiny's encoder, cross-attention and
    causal decoder; q × 8, dq, dk, dv against the plain version's
    autograd in float64, the bf16 call on the route ``route`` names."""
    tdt = DTYPES[dt]
    q = torch.from_numpy(rn(80, B, Sq, Hq, D) * 8.0).to(cuda, tdt)
    k = torch.from_numpy(rn(81, B, Skv, Hkv, D)).to(cuda, tdt)
    v = torch.from_numpy(rn(82, B, Skv, Hkv, Dv)).to(cuda, tdt)
    dout = torch.from_numpy(rn(83, B, Sq, Hq, Dv)).to(cuda, tdt)
    routes = tfa.bwd_routes()
    got, want = _attention_grads_on_card(q, k, v, dout, kw, Sq, Skv)
    taken = {r: n - routes[r] for r, n in tfa.bwd_routes().items()}
    route = tfa.route(tdt, D, Dv)
    assert taken == {r: int(r == route) for r in taken}
    _hold_gradients(got, want, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_wgmma_route_as_a_threads_first_cuda_work(cuda, direction):
    """The wgmma routes encode TMA tensor maps, which fail in a thread
    with no current context: each direction must run as the first CUDA
    work of a new thread (as in an autograd worker whose first node is
    the attention backward), after the main thread ran it, and match
    the main thread's result bit for bit."""
    q, k, v, dout = (torch.from_numpy(rn(90 + i, 1, 256, 4, 64)).to(
        cuda, torch.bfloat16) for i in range(4))

    def call():
        if direction == "forward":
            return (tfa.flash_attention_cuda(q, k, v, True, None, None,
                                             0.125, 128, 128),)
        _, lse = tfa.flash_attention_lse_cuda(q, k, v, True, None, None,
                                              0.125)
        return tfa.flash_attention_bwd_cuda(dout, q, k, v, lse, True, None,
                                            None, 0.125)

    want = call()
    got, errors = [], []

    def body():
        try:
            got.extend(call())
            torch.cuda.synchronize()
        except Exception as exc:   # raised again in the test's thread
            errors.append(exc)

    worker = threading.Thread(target=body)
    worker.start()
    worker.join()
    assert not errors, errors
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("mn_major,n", [(False, 64), (True, 64), (True, 128),
                                        (True, 192), (True, 256)])
def test_wgmma_descriptors_and_swizzle_on_card(cuda, mn_major, n):
    """The bf16 backward's wgmma operand layouts alone: a 64 × N × 256
    product of TMA-loaded 128-byte-swizzled tiles, B read K-major with A
    from shared memory (the score products) or MN-major with A from
    registers (the sums), against ``torch.matmul`` in f32.  A wrong
    descriptor gives wrong numbers, not a fault; products of bf16 values
    are exact in f32, so only the summation order differs."""
    a = torch.from_numpy(rn(60, 64, 256)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rn(61, *((256, n) if mn_major else (n, 256)))).to(
        cuda, torch.bfloat16)
    got = tfa.wgmma_tile_product(a, b, mn_major)
    want = a.float() @ (b.float() if mn_major else b.float().T)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv,offset", [
    (256, 256, 0), (112, 112, 0), (192, 128, 0), (40, 40, 0), (48, 33, 0),
    (20, 20, 0), (64, 64, 1)])
def test_flash_attention_backward_route_on_card(cuda, D, Dv, offset):
    """The bf16 backward takes the wgmma route exactly where
    ``route`` says and every operand is 16-byte aligned (``offset``
    1 shifts q, k, v and dout by one element), else the mma.sync route,
    and both give the plain version's gradients."""
    B, S, Hq, Hkv = 1, 160, 4, 2

    def on_card(seed, *shape, factor=1.0):
        flat = torch.from_numpy(rn(seed, int(np.prod(shape)) + offset)
                                * factor)
        return flat.to(cuda, torch.bfloat16)[offset:].view(*shape)

    q = on_card(70, B, S, Hq, D, factor=8.0)
    k, v = on_card(71, B, S, Hkv, D), on_card(72, B, S, Hkv, Dv)
    dout = on_card(73, B, S, Hq, Dv)
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    kw = dict(causal=True, window=48, softcap=30.0)
    scale = D ** -0.5
    _, lse = tfa.flash_attention_lse_cuda(q.clone(), k.clone(), v.clone(),
                                          True, 48, 30.0, scale)
    before = tfa.bwd_routes()
    got = tfa.flash_attention_bwd_cuda(dout, q, k, v, lse, True, 48, 30.0,
                                       scale)
    taken = {r: n - before[r] for r, n in tfa.bwd_routes().items()}
    route = tfa.route(torch.bfloat16, D, Dv, aligned=not offset)
    assert taken == {r: int(r == route) for r in taken}
    wide = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.attention_ref(*wide, scale=scale, **kw),
                               wide, dout.double())
    _hold_gradients(got, want, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dt,D", [("float32", 128), ("bfloat16", 128),
                                  ("bfloat16", 192), ("bfloat16", 256)])
def test_flash_attention_backward_is_bit_for_bit_repeatable(cuda, dt, D):
    """No atomics: backward runs on the same inputs agree bit for bit
    (in bf16 at each of the wgmma route's ring depths: four stages at D
    128, two for Δ and dQ and three for dK+dV at 192, two at 256)."""
    q, k, v = _attention_inputs(cuda, dt, 2, 320, 8, 2, D, q_scale=8.0)
    dout = torch.from_numpy(rn(74, 2, 320, 8, D)).to(cuda, DTYPES[dt])
    args = (True, 100, 50.0, D ** -0.5)
    _, lse = tfa.flash_attention_lse_cuda(q, k, v, *args)
    first = tfa.flash_attention_bwd_cuda(dout, q, k, v, lse, *args)
    for _ in range(3):
        again = tfa.flash_attention_bwd_cuda(dout, q, k, v, lse, *args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_lse_is_the_rows_logsumexp(cuda, dt):
    """The forward's lse output: each row's log-sum-exp of its scaled,
    capped, masked scores; the output is the no-lse launch's, bit for
    bit."""
    kw = dict(causal=True, window=40, softcap=30.0)
    q, k, v = _attention_inputs(cuda, dt, 2, 256, 8, 2, 64, q_scale=8.0)
    scale = 1.0 / 8.0
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, True, 40, 30.0, scale)
    plain_out = tfa.flash_attention_cuda(q, k, v, True, 40, 30.0, scale,
                                         64, 64)
    assert torch.equal(out, plain_out)
    qd, kd = q.double(), k.double().repeat_interleave(4, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    s = 30.0 * torch.tanh(s / 30.0)
    i = torch.arange(256, device=cuda)
    mask = (i[:, None] >= i[None]) & (i[:, None] - i[None] < 40)
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    assert float((lse.double() - want).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the recurrent backward kernels (csrc/mamba2_ssd_bwd.cu,
# csrc/slstm_cell_bwd.cu)
# ---------------------------------------------------------------------------


def _recurrent_grads_on_card(module, op, plain, args, dy, **kw):
    """The kernel's gradients through ``ops`` under autograd (each kernel
    launched once, forward and backward) and the plain version's autograd
    on float64 copies."""
    leaves = [t.clone().requires_grad_() for t in args]
    before = (module.launches, module.backward_launches)
    got = torch.autograd.grad(op(*leaves, **kw), leaves, dy)
    assert (module.launches, module.backward_launches) == (before[0] + 1,
                                                           before[1] + 1)
    want = tref.plain_vjp(plain, [t.double() for t in args], dy.double())
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,shift", [
    *(shape + (0.0,) for shape in SSD_SHAPES),
    (1, 96, 2, 20, 12, 48, 0.0),     # P, N not multiples of 4 or 8
    (1, 128, 3, 64, 64, 64, 5.0),    # strong decay: exp(la_i − la_j) = 0
    (2, 160, 2, 8, 16, 160, 0.0),    # chunk 160: the kernel's chunk 40
    (1, 64, 2, 1, 1, 16, 0.0),       # P = N = 1
])
def test_mamba2_ssd_backward_kernel_on_card(cuda, B, S, H, P, N, chunk,
                                            shift):
    """Every gradient within 1e-4 × its max |g| of the float64 vjp of the
    plain recurrence; where S spans chunks, the plain variants without
    the carried state gradient, or with it one chunk late, lie outside."""
    xdt = torch.from_numpy(rn(60, B, S, H, P)).to(cuda)
    da = torch.from_numpy(-np.abs(rn(61, B, S, H)) * 0.1 - shift).to(cuda)
    bm = torch.from_numpy(rn(62, B, S, H, N)).to(cuda)
    cm = torch.from_numpy(rn(63, B, S, H, N)).to(cuda)
    dy = torch.from_numpy(rn(64, B, S, H, P)).to(cuda)
    got, want = _recurrent_grads_on_card(
        tssd, tops.mamba2_ssd, tref.ssd_ref, (xdt, da, bm, cm), dy,
        chunk=chunk)
    _hold_gradients(got, want, "float32")
    if S > tssd.inner_chunk(chunk):
        wide = [t.double() for t in (xdt, da, bm, cm, dy)]
        for wrong in (variants.ssd_bwd_without_carried_gradient,
                      variants.ssd_bwd_gradient_one_chunk_late):
            bad = wrong(*wide, tssd.inner_chunk(chunk))
            with pytest.raises(AssertionError):
                _hold_gradients(got, bad, "float32")


def _ssd_operands(cuda, B, S, H, P, N, shift):
    """x·dt, dt·A (−0.1·|randn| − shift), B, C and dy on the card from
    seeds 60–64, as test_mamba2_ssd_backward_kernel_on_card makes them."""
    def on_card(seed, *shape, scale=1.0, add=0.0):
        a = rn(seed, *shape)
        if scale != 1.0:
            a = -np.abs(a) * scale
        return torch.from_numpy(a + add).to(cuda)
    return (on_card(60, B, S, H, P), on_card(61, B, S, H, scale=0.1,
                                              add=-shift),
            on_card(62, B, S, H, N), on_card(63, B, S, H, N),
            on_card(64, B, S, H, P))


@pytest.mark.gpu
@pytest.mark.parametrize("a_trans", [False, True])
def test_wgmma_tf32_descriptors_and_split_on_card(cuda, a_trans):
    """The chained-scan route's TF32 wgmma layouts alone: a 64 × 64 × 64
    product, A from registers (natural or transposed reads of a TMA-loaded
    128-byte-swizzled f32 tile), B a K-major tile read by descriptor, 32
    rows a warpgroup, in the kernels' three-product error compensation,
    against float64: within 1e-5 of Σ|a·b| (a wrong descriptor or
    fragment layout gives wrong numbers, not a fault)."""
    a = torch.from_numpy(rn(80, 64, 64)).to(cuda)
    b = torch.from_numpy(rn(81, 64, 64)).to(cuda)
    A = (a.T if a_trans else a).double()
    want = A @ b.double().T
    scale = float((A.abs() @ b.double().abs().T).max())
    got = tssd.wgmma_tf32_tile_product(a, b, a_trans, True)
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("a_trans", [False, True])
def test_wgmma_tf32_reads_f32_bits_truncated_on_card(cuda, a_trans):
    """What the tensor cores make of an f32 operand's bits in a TF32
    wgmma: the product of raw f32 tiles agrees with the float64 product
    of their values truncated to 10 mantissa bits, and not with their
    values rounded to nearest (cvt.rna.tf32's hi) — so a kernel that
    splits x = hi + lo must store hi itself, as the kernels do."""
    a = torch.from_numpy(rn(82, 64, 64)).to(cuda)
    b = torch.from_numpy(rn(83, 64, 64)).to(cuda)
    a_op = (a.T if a_trans else a).contiguous()

    def truncated(t):
        return (t.view(torch.int32) & ~0x1FFF).view(torch.float32).double()

    def rounded(t):
        i = t.view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32).double()

    scale = float((a_op.double().abs() @ b.double().abs().T).max())
    got = tssd.wgmma_tf32_tile_product(a, b, a_trans, False).double()
    err_trunc = float((got - truncated(a_op) @ truncated(b).T).abs().max())
    err_round = float((got - rounded(a_op) @ rounded(b).T).abs().max())
    assert err_trunc <= 1e-5 * scale < err_round


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,shift", [
    # test_mamba2_ssd_backward_kernel_on_card's shapes
    *(shape + (0.0,) for shape in SSD_SHAPES),
    (1, 96, 2, 20, 12, 48, 0.0), (1, 128, 3, 64, 64, 64, 5.0),
    (2, 160, 2, 8, 16, 160, 0.0), (1, 64, 2, 1, 1, 16, 0.0),
])
def test_mamba2_ssd_backward_route_on_card(cuda, B, S, H, P, N, chunk,
                                           shift):
    """The SSD backward takes the chained scans exactly where
    ``bwd_route`` says (the kernel's chunk 64, P and N multiples of 8),
    else the five passes, and both give the plain version's gradients
    within 1e-4 × each max |g|."""
    x, da, bm, cm, dy = _ssd_operands(cuda, B, S, H, P, N, shift)
    before = dict(tssd.bwd_route_launches)
    got = tssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy, chunk)
    taken = {r: n - before[r] for r, n in tssd.bwd_route_launches.items()}
    route = tssd.bwd_route(P, N, chunk)
    assert taken == {r: int(r == route) for r in taken}
    want = tref.plain_vjp(tref.ssd_ref, [t.double() for t in
                                         (x, da, bm, cm)], dy.double())
    _hold_gradients(got, want, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,shift", [
    (1, 256, 2, 64, 64, 64, 0.0), (2, 512, 3, 64, 64, 256, 0.0),
    (1, 256, 2, 64, 64, 64, 5.0), (2, 384, 2, 32, 48, 128, 0.0)])
def test_mamba2_ssd_backward_is_bit_for_bit_repeatable(cuda, B, S, H, P, N,
                                                      chunk, shift):
    """The chained scans take their tickets in whatever order blocks
    start, but every link and sum is a fixed formula: four runs at the
    kernel's chunk 64 (B 2, a strong decay, P 32 / N 48 among them) agree
    bit for bit."""
    x, da, bm, cm, dy = _ssd_operands(cuda, B, S, H, P, N, shift)
    assert tssd.bwd_route(P, N, chunk) == "chain"
    first = tssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy, chunk)
    for _ in range(3):
        again = tssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy, chunk)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 2, 64, 64, 256),    # the chained scans' shape, routed away
    (2, 128, 3, 32, 16, 64),     # the same at the kernel's own chunk
    (1, 96, 2, 20, 12, 48),      # the five passes' own shape
])
def test_mamba2_ssd_on_unaligned_operands(cuda, B, S, H, P, N, chunk):
    """Every operand a contiguous view one float past a 16-byte boundary
    (P and N multiples of 4, where the kernels would stage 16 bytes at a
    time): the forward the same bits as on aligned copies (the staging
    copies the same floats) and within the reference's elementwise f32
    tolerance of the float64 plain version, and the backward on the five
    passes, each gradient within 1e-4 × its max |g| of the float64
    vjp."""
    aligned = _ssd_operands(cuda, B, S, H, P, N, 0.0)
    x, da, bm, cm, dy = (_unaligned(t.cpu().numpy(), cuda) for t in aligned)
    y = tops.mamba2_ssd(x, da, bm, cm, chunk=chunk)
    assert torch.equal(y, tops.mamba2_ssd(*aligned[:4], chunk=chunk))
    _check(y, tref.ssd_ref, x, da, bm, cm)
    before = dict(tssd.bwd_route_launches)
    got = tssd.mamba2_ssd_bwd_cuda(x, da, bm, cm, dy, chunk)
    assert {r: n - before[r] for r, n in tssd.bwd_route_launches.items()} \
        == {"chain": 0, "passes": 1}
    want = tref.plain_vjp(tref.ssd_ref, [t.double() for t in
                                         (x, da, bm, cm)], dy.double())
    _hold_gradients(got, want, "float32")


@pytest.mark.gpu
def test_mamba2_ssd_forward_at_zamba2_layer_width(cuda):
    """The forward at zamba2-7b's layer (B 1, S 4096, H 112, P = N = 64,
    its chunk 256) within the reference's elementwise f32 tolerance of
    the float64 plain version, on seeds 60–63 as the other SSD cases."""
    x, da, bm, cm, _ = _ssd_operands(cuda, 1, 4096, 112, 64, 64, 0.0)
    _check(tops.mamba2_ssd(x, da, bm, cm, chunk=256), tref.ssd_ref, x, da,
           bm, cm)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh,floor", [
    *(shape + (False,) for shape in SLSTM_SHAPES),
    (2, 16, 2, 256, False),    # 8-block clusters
    (3, 12, 2, 4, False),      # one unit a block, four blocks idle
    (9, 12, 2, 192, False),    # B·H over the resident clusters: 2 rows
    (2, 20, 2, 64, True),      # the n floor bites for half the units
])
def test_slstm_cell_backward_kernel_on_card(cuda, B, S, H, dh, floor):
    """Every gradient within 1e-4 × its max |g| of the float64 vjp of the
    plain loop; the plain variant without the recurrent dh lies
    outside."""
    g_in = rn(65, B, S, 4, H, dh) * 0.5
    if floor:
        g_in[:, :, 0, :, : dh // 2] -= 30.0
    g_in = torch.from_numpy(g_in).to(cuda)
    r = torch.from_numpy(rn(66, H, dh, 4, dh) * 0.1).to(cuda)
    b = torch.from_numpy(rn(67, 4, H, dh) * 0.1).to(cuda)
    dy = torch.from_numpy(rn(68, B, S, H, dh)).to(cuda)
    got, want = _recurrent_grads_on_card(tsc, tops.slstm_cell,
                                         tref.slstm_cell_ref, (g_in, r, b),
                                         dy)
    _hold_gradients(got, want, "float32")
    h, traj = tref.slstm_cell_fwd_traj_ref(g_in.double(), r.double(),
                                           b.double())
    if floor:
        assert float(traj[:, :, 5].min()) < 1e-6
    bad = variants.slstm_bwd_without_recurrence(traj, h, r.double(),
                                                dy.double())
    with pytest.raises(AssertionError):
        _hold_gradients(got, bad, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh", [
    (1, 16, 2, 192), (2, 16, 2, 256), (3, 12, 2, 4), (9, 12, 2, 192),
    (2, 24, 4, 50)])
def test_slstm_cell_backward_partials_and_repeat_on_card(cuda, B, S, H, dh):
    """One launch's per-cluster partial sums of dR and db within 1e-4 ×
    each max |g| of the plain partials for the plan's rows a cluster; a
    second launch bit for bit (no atomics); and the dg_in-only launch's
    dgg the same bits as the full launch's."""
    g_in = torch.from_numpy(rn(75, B, S, 4, H, dh) * 0.5).to(cuda)
    r = torch.from_numpy(rn(76, H, dh, 4, dh) * 0.1).to(cuda)
    b = torch.from_numpy(rn(77, 4, H, dh) * 0.1).to(cuda)
    dy = torch.from_numpy(rn(78, B, S, H, dh)).to(cuda)
    h, traj = tsc.slstm_cell_traj_cuda(g_in, r, b)
    dgg, dr_part, db_part = tsc._bwd_launch(traj, h, r, dy)
    rows = tsc.bwd_plans[(g_in.device, B, H, dh)]["rows_per_cluster"]
    _, hw, rw, dyw = (t.double() for t in (g_in, h, r, dy))
    want_dgg = tref.slstm_cell_bwd_ref(traj.double(), hw, rw, dyw)[0]
    want = tref.slstm_param_partials_ref(hw, want_dgg, rows)
    _hold_gradients((dgg, dr_part, db_part), (want_dgg, *want), "float32")
    again = tsc._bwd_launch(traj, h, r, dy)
    assert all(torch.equal(x, y) for x, y in
               zip((dgg, dr_part, db_part), again))
    assert torch.equal(tsc.slstm_cell_dgg_cuda(traj, r, dy), dgg)


@pytest.mark.gpu
def test_trajectory_forward_is_the_plain_launch_and_the_plain_trajectory(
        cuda):
    """The forward with its trajectory pointer set gives the no-trajectory
    launch's h bit for bit, and a trajectory within the f32 tolerance of
    the plain version's in float64."""
    g_in = torch.from_numpy(rn(69, 3, 40, 4, 2, 48) * 0.5).to(cuda)
    r = torch.from_numpy(rn(70, 2, 48, 4, 48) * 0.1).to(cuda)
    b = torch.from_numpy(rn(71, 4, 2, 48) * 0.1).to(cuda)
    h, traj = tsc.slstm_cell_traj_cuda(g_in, r, b)
    assert torch.equal(h, tsc.slstm_cell_cuda(g_in, r, b))
    _, want = tref.slstm_cell_fwd_traj_ref(g_in.double(), r.double(),
                                           b.double())
    np.testing.assert_allclose(traj.double().cpu().numpy(),
                               want.cpu().numpy(), **TOL["float32"])


@pytest.mark.gpu
def test_recurrent_backward_launch_failure_raises(cuda, monkeypatch):
    """A launch the kernels refuse raises, from the C entry and through
    autograd's backward: nothing falls back to the plain vjp."""
    g_in = torch.from_numpy(rn(72, 1, 8, 4, 2, 16)).to(cuda)
    with pytest.raises(RuntimeError, match="repro_ssd_chunk_grad_f32"):
        _build.launch_on(g_in.device, "repro_ssd_chunk_grad_f32", *[0] * 11,
                         1, 64, 2, 16, 16, 65)   # a chunk over 64
    r = torch.from_numpy(rn(73, 2, 16, 4, 16) * 0.1).to(cuda)
    b = torch.from_numpy(rn(74, 4, 2, 16) * 0.1).to(cuda).requires_grad_()
    monkeypatch.setitem(tsc.bwd_plans, (g_in.device, 1, 2, 16),
                        dict(cluster_blocks=5, rows_per_cluster=1))
    h = tops.slstm_cell(g_in, r, b)
    with pytest.raises(RuntimeError, match="repro_slstm_cell_bwd_f32"):
        h.sum().backward()
