"""The SSD backward's two CUDA routes, on the CPU: which shapes take the
chained scans (``mamba2_ssd.bwd_route``) and what the cost rule's staging
term counts for each (``kernelcost.mamba2_ssd_bwd_cost``); the kernels
themselves run only on the card (``tests/test_torch_gpu.py``)."""
import pytest
import torch

from repro_torch.analysis import kernelcost
from repro_torch.analysis.targets import f32
from repro_torch.core.counting import count_fn
from repro_torch.kernels import mamba2_ssd

#: head and state widths, and the caller's chunk → the kernel's chunk
DIMS = (1, 12, 16, 20, 64)
KERNEL_CHUNK = {16: 16, 48: 48, 64: 64, 160: 40, 256: 64}
ROUTE_CHUNKS = sorted(KERNEL_CHUNK)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("chunk", ROUTE_CHUNKS)
def test_bwd_route_takes_the_chained_scans_where_they_apply(chunk, aligned):
    """The chained scans need the kernel's chunk at 64, P and N multiples
    of 8 and aligned operands; every other shape keeps the five passes."""
    assert mamba2_ssd.inner_chunk(chunk) == KERNEL_CHUNK[chunk]
    for p in DIMS:
        for n in DIMS:
            chain = (aligned and KERNEL_CHUNK[chunk] == 64
                     and p % 8 == 0 and n % 8 == 0)
            assert mamba2_ssd.bwd_route(p, n, chunk, aligned=aligned) == \
                ("chain" if chain else "passes"), (p, n)
            if aligned:
                assert mamba2_ssd.bwd_route(p, n, chunk) == \
                    mamba2_ssd.bwd_route(p, n, chunk, aligned=True)


def _staging(p, n, chunk, route):
    """Floats staged per kernel chunk, written out from the kernels'
    shared-memory layouts (64-row tiles of at most 64 columns)."""
    lk, tile = mamba2_ssd.inner_chunk(chunk), 64 * 64
    if route == "chain":
        # pass F: x, B; Bᵀ hi and lo; ds; la and w
        f = lk * (p + n) + 3 * tile + 2 * lk
        # pass R: C, dy, B, x and S_c by TMA; the four tiles' hi in place
        # and lo; G_{c+1} and Glocᵀ; (e∘dy)ᵀ, Q, M, Q written as hi and
        # lo; la, e and w
        r = (lk * (2 * p + 2 * n) + p * n + 2 * lk * (2 * p + 2 * n)
             + 2 * tile + 4 * 2 * tile + 3 * lk)
        return f + r
    # the forward's (a) and (a′): x and B, x scaled, la and w; (c′): C, B,
    # x, dy, la, the state and its gradient, M and Q
    a = lk * (2 * p + n + 2)
    c = lk * (2 * p + 2 * n + 1) + 2 * p * n + 2 * tile
    return 2 * a + c


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 4, 64, 64, 256), (1, 256, 2, 16, 32, 64), (2, 128, 2, 8, 8, 64),
    (1, 256, 4, 64, 64, 32), (1, 96, 2, 20, 12, 48), (2, 160, 2, 8, 16, 160),
    (1, 64, 2, 1, 1, 16)])
def test_bwd_staging_term_follows_the_route(B, S, H, P, N, chunk):
    """A training step's SSD on fake tensors: the backward rule's staging
    term is its route's per kernel chunk, and the route moves nothing
    else the rule counts (the same function on the same grid)."""
    args = (f32(B, S, H, P), f32(B, S, H), f32(B, S, H, N), f32(B, S, H, N))
    dy = f32(B, S, H, P)
    route = mamba2_ssd.bwd_route(P, N, chunk)
    got = kernelcost.mamba2_ssd_bwd_cost(*args, dy, chunk)
    chunks = B * H * S // mamba2_ssd.inner_chunk(chunk)
    assert got["f_vmem_contig_float32_store"] == \
        chunks * _staging(P, N, chunk, route)
    assert kernelcost.ssd_bwd_staging(P, N, chunk) == \
        _staging(P, N, chunk, route)
    # the other route's staging, on the same shapes: only that term moves
    other = "passes" if route == "chain" else "chain"
    assert _staging(P, N, chunk, other) != _staging(P, N, chunk, route)
    # the counter prices the backward op by this rule, one launch
    counted = count_fn(mamba2_ssd.mamba2_ssd_bwd, *args, dy, chunk)
    assert dict(counted) == {**{k: v for k, v in got.items() if v},
                             "f_sync_launch_kernel": 1}


def _at_offset(shape, floats):
    """A contiguous float32 tensor of ``shape`` starting ``floats`` past a
    16-byte boundary (a view of a larger buffer)."""
    n = 1
    for d in shape:
        n *= d
    t = torch.zeros(n + 4)[floats:floats + n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 4 * floats
    return t


@pytest.mark.parametrize("which", range(5))
def test_an_unaligned_operand_takes_the_five_passes(which):
    """A call whose operands fit the chained scans takes them only where
    every operand starts on a 16-byte boundary: one view at an odd float
    offset sends it to the five passes (which stage it 4 bytes at a
    time)."""
    B, S, H, P, N, chunk = 1, 256, 2, 64, 64, 256
    shapes = ((B, S, H, P), (B, S, H), (B, S, H, N), (B, S, H, N),
              (B, S, H, P))
    aligned = [_at_offset(s, 0) for s in shapes]
    assert mamba2_ssd.operand_route(*aligned, chunk) == "chain"
    ops = list(aligned)
    ops[which] = _at_offset(shapes[which], 1)
    assert mamba2_ssd.operand_route(*ops, chunk) == "passes"
