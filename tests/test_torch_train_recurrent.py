"""The SSD's and the sLSTM's gradients, as their backward kernels compute
them, against the reference on the CPU.

``ref.ssd_bwd_ref`` (the chunked SSD run backwards, the algorithm of
``csrc/mamba2_ssd_bwd.cu``) against ``jax.vjp`` of the reference's
``_ssd_chunked`` (B and C per group there, repeated to heads in the port)
and of its sequential ``ssd_ref``; ``ref.slstm_cell_bwd_ref`` (the
reverse recurrence of ``csrc/slstm_cell_bwd.cu``) against ``jax.vjp`` of
a ``lax.scan`` over the reference's ``_slstm_cell``; the trajectory
forward against the plain forward; each within 1e-4 × max |g|.  On fake
tensors the counter prices a forward + backward through ``ops.mamba2_ssd``
and ``ops.slstm_cell`` by the backward ops' cost rules and launches
nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.analysis import kernelcost
from repro_torch.analysis.targets import f32
from repro_torch.core.counting import count_fn
from repro_torch.kernels import _build, mamba2_ssd, ops, ref, slstm_cell

GRAD_REL = 1e-4


def _rn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _hold(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()


def _ssd_inputs(seed, Bz, S, H, P, N, G, decay):
    rng = np.random.default_rng(seed)
    return (_rn(rng, Bz, S, H, P),
            (-np.abs(rng.standard_normal((Bz, S, H))) * decay
             ).astype(np.float32),
            _rn(rng, Bz, S, G, N), _rn(rng, Bz, S, G, N),
            _rn(rng, Bz, S, H, P))


def _heads(a, H):
    return torch.from_numpy(a).repeat_interleave(H // a.shape[2], dim=2)


@pytest.mark.parametrize("S,chunk,decay,G", [
    (64, 16, 0.2, 1),    # four chunks
    (64, 32, 0.2, 2),    # two chunks, two groups
    (96, 32, 5.0, 1),    # strong decay: exp(la_i − la_j) underflows
    (48, 48, 0.5, 1),    # one chunk: no carried state
])
def test_ssd_bwd_ref_matches_reference_chunked_scan(S, chunk, decay, G):
    H, P, N = 4, 8, 6
    xdt, da, bm, cm, dy = _ssd_inputs(S + chunk, 2, S, H, P, N, G, decay)

    def jfn(xdt, da, bm, cm):
        return jssm._ssd_chunked(xdt, da, bm, cm, chunk=chunk)[0]
    _, vjp = jax.vjp(jfn, xdt, da, bm, cm)
    jdx, jda, jdb, jdc = vjp(dy)
    got = ref.ssd_bwd_ref(torch.from_numpy(xdt), torch.from_numpy(da),
                          _heads(bm, H), _heads(cm, H),
                          torch.from_numpy(dy), chunk)
    # the groups' gradients are the sums over their heads
    dbg = got[2].reshape(2, S, G, H // G, N).sum(3)
    dcg = got[3].reshape(2, S, G, H // G, N).sum(3)
    _hold((got[0], got[1], dbg, dcg), (jdx, jda, jdb, jdc))


@pytest.mark.parametrize("S,chunk", [(40, 16), (64, 64), (60, 8)])
def test_ssd_bwd_ref_matches_reference_sequential_scan(S, chunk):
    """Against ``jax.vjp`` of the reference's sequential ``ssd_ref``;
    a length that is not a chunk multiple is padded as the model pads it
    (dt·A = 0 and x = 0 past S), so the padding steps are no-ops."""
    H, P, N = 3, 5, 7
    xdt, da, bm, cm, dy = _ssd_inputs(S, 1, S, H, P, N, H, 0.3)
    _, vjp = jax.vjp(jref.ssd_ref, xdt, da, bm, cm)
    want = vjp(dy)
    pad = -(-S // chunk) * chunk - S

    def padded(a):
        t = torch.from_numpy(a)
        return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))],
                         1)
    got = ref.ssd_bwd_ref(*map(padded, (xdt, da, bm, cm, dy)), chunk)
    _hold([g[:, :S] for g in got], want)


def _slstm_inputs(seed, Bz, S, H, dh, floor):
    rng = np.random.default_rng(seed)
    g_in = _rn(rng, Bz, S, 4, H, dh, scale=0.5)
    if floor:   # input gates far below the forget gates: n < 1e-6
        g_in[:, :, 0, :, : dh // 2] -= 30.0
    return (g_in, _rn(rng, H, dh, 4, dh, scale=0.1),
            _rn(rng, 4, H, dh, scale=0.1), _rn(rng, Bz, S, H, dh))


def _jscan(g_in, r, bias):
    zeros = jnp.zeros((g_in.shape[0], *g_in.shape[3:]), jnp.float32)
    _, hs = jax.lax.scan(
        lambda s, gi: jxlstm._slstm_cell({"r_gates": r, "b_gates": bias}, s,
                                         gi),
        (zeros,) * 4, g_in.swapaxes(0, 1))
    return hs.swapaxes(0, 1)


@pytest.mark.parametrize("Bz,S,H,dh,floor", [
    (2, 16, 4, 16, False),
    (1, 24, 2, 8, True),     # the n floor bites for half the units
    (3, 8, 1, 4, False),
])
def test_slstm_cell_bwd_ref_matches_reference_scan(Bz, S, H, dh, floor):
    g_in, r, bias, dy = _slstm_inputs(S + dh, Bz, S, H, dh, floor)
    _, vjp = jax.vjp(_jscan, g_in, r, bias)
    want = vjp(dy)
    h, traj = ref.slstm_cell_fwd_traj_ref(*map(torch.from_numpy,
                                               (g_in, r, bias)))
    if floor:
        assert float(traj[:, :, 5].min()) < 1e-6 < float(traj[:, :, 5].max())
    got = ref.slstm_cell_bwd_ref(traj, h, torch.from_numpy(r),
                                 torch.from_numpy(dy))
    _hold(got, want)


@pytest.mark.parametrize("floor", [False, True])
def test_trajectory_forward_matches_the_plain_forward(floor):
    """The trajectory forward's h and its last step's (c, n, m) equal
    ``slstm_cell_state_ref``'s; its gate rows are the plain step's
    pre-activations (g_in + h_{t−1}·R + b)."""
    g_in, r, bias, _ = _slstm_inputs(3, 2, 12, 3, 8, floor)
    args = tuple(map(torch.from_numpy, (g_in, r, bias)))
    h, traj = ref.slstm_cell_fwd_traj_ref(*args)
    want_h, cnm = ref.slstm_cell_state_ref(*args)
    assert traj.shape == (2, 12, slstm_cell.TRAJ_ROWS, 3, 8)
    assert torch.equal(h, want_h)
    for got, want in zip(traj[:, -1, 4:].unbind(1), cnm):
        assert torch.equal(got, want)
    hp = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    gg = args[0] + torch.einsum("bshd,hdge->bsghe", hp, args[1]) + args[2]
    np.testing.assert_allclose(traj[:, :, :4].numpy(), gg.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_host_gradients_go_through_the_backward_ops():
    """``ops.mamba2_ssd`` and ``ops.slstm_cell`` under autograd on the
    host: the gradients are the backward ops' (their plain algorithms),
    and nothing launches."""
    xdt, da, bm, cm, dy = _ssd_inputs(11, 1, 64, 2, 8, 4, 2, 0.3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xdt, da, bm, cm)]
    before = (mamba2_ssd.launches, mamba2_ssd.backward_launches,
              slstm_cell.launches, slstm_cell.backward_launches)
    y = ops.mamba2_ssd(*leaves, chunk=32)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = ref.ssd_bwd_ref(*(t.detach() for t in leaves),
                           torch.from_numpy(dy), 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    g_in, r, bias, dh = _slstm_inputs(12, 2, 10, 2, 8, False)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (g_in, r, bias)]
    h = ops.slstm_cell(*leaves)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    plain = ref.plain_vjp(ref.slstm_cell_ref, leaves, torch.from_numpy(dh))
    _hold(got, [p.numpy() for p in plain])
    assert (mamba2_ssd.launches, mamba2_ssd.backward_launches,
            slstm_cell.launches, slstm_cell.backward_launches) == before


def _sum(*counts):
    out = counts[0].__class__()
    for c in counts:
        for feat, v in c.items():
            out.add(feat, v)
    return out


def _fwd_bwd(fn):
    """Forward + backward of ``fn`` for the output gradient passed last
    (an input, so that seeding it counts nothing)."""
    def run(*args):
        leaves = [t.requires_grad_() for t in args[:-1]]
        return torch.autograd.grad(fn(*leaves), leaves, args[-1])
    return run


def test_counter_prices_the_recurrent_backwards_by_their_cost_rules():
    """A training step's SSD and sLSTM on fake tensors: forward + backward
    is the forward's rule (the sLSTM's with its trajectory) plus the
    backward op's rule, feature for feature; nothing runs or launches."""
    before = (mamba2_ssd.launches, mamba2_ssd.backward_launches,
              slstm_cell.launches, slstm_cell.backward_launches)
    chunk = 64
    ssd = (f32(1, 256, 4, 32), f32(1, 256, 4), f32(1, 256, 4, 16),
           f32(1, 256, 4, 16))
    both = count_fn(_fwd_bwd(lambda *t: ops.mamba2_ssd(*t, chunk=chunk)),
                    *ssd, f32(1, 256, 4, 32))
    want = _sum(kernelcost.mamba2_ssd_cost(*ssd, chunk),
                kernelcost.mamba2_ssd_bwd_cost(*ssd, ssd[0], chunk))
    for feat, v in want.items():
        assert both[feat] == v, feat
    sl = (f32(2, 32, 4, 2, 16), f32(2, 16, 4, 16), f32(4, 2, 16))
    both = count_fn(_fwd_bwd(ops.slstm_cell), *sl, f32(2, 32, 2, 16))
    want = _sum(kernelcost.slstm_cell_traj_cost(*sl),
                kernelcost.slstm_cell_bwd_cost(
                    f32(2, 32, slstm_cell.TRAJ_ROWS, 2, 16),
                    f32(2, 32, 2, 16), sl[1], f32(2, 32, 2, 16)))
    for feat, v in want.items():
        assert both[feat] == v, feat
    # the trajectory is the forward's only extra cost; the backward's
    # needed products are twice the forward's (R·dgg and dR)
    fwd = kernelcost.slstm_cell_cost(*sl)
    assert both["f_op_float32_madd"] == 3 * fwd["f_op_float32_madd"]
    assert (mamba2_ssd.launches, mamba2_ssd.backward_launches,
            slstm_cell.launches, slstm_cell.backward_launches) == before


def test_backward_kernels_are_built_and_bound():
    """The two backward sources are in the library, each C entry point
    they define (the SSD's both routes and its TF32 wgmma check) has its
    ctypes signature, and the forward's sLSTM entry takes the trajectory
    pointer."""
    for src in ("mamba2_ssd_bwd.cu", "slstm_cell_bwd.cu"):
        assert src in _build.SOURCES
    names = ("repro_ssd_chunk_state_grad_f32", "repro_ssd_state_grad_pass_f32",
             "repro_ssd_chunk_grad_f32", "repro_slstm_cell_bwd_f32",
             "repro_slstm_cell_bwd_plan", "repro_ssd_bwd_chain_f32",
             "repro_wgmma_tile_tf32")
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name in names:
        assert f'extern "C" int {name}(' in text
        assert name in _build.SIGNATURES
    assert mamba2_ssd.BWD_PASSES == names[:3]
    assert mamba2_ssd.BWD_CHAIN == names[5]
    # g_in, r, b, y, state, traj, then six ints and the stream
    assert len(_build.SIGNATURES["repro_slstm_cell_f32"]) == 13


def _outside(got, want):
    """Whether any gradient lies outside 1e-4 × its max |g| of ``want``."""
    return any(float((g - w).abs().max()) > GRAD_REL * float(w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("variant", ["ssd_bwd_without_carried_gradient",
                                     "ssd_bwd_gradient_one_chunk_late",
                                     "slstm_bwd_without_recurrence"])
def test_backward_variants_fail_the_gradient_check(variant):
    """Each plain variant of the backward kernels (the card's check holds
    the kernels to rejecting them) lies outside the tolerance on
    ``chip_smoke.py`` phase 17's kind of inputs."""
    from repro_torch.testing import variants
    fn = getattr(variants, variant)
    if variant.startswith("ssd"):
        args = [torch.from_numpy(a).double() for a in _ssd_inputs(
            5, 1, 128, 3, 8, 6, 3, 0.1)]
        want = ref.ssd_bwd_ref(*args, 32)
        got = fn(*args, 32)
    else:
        g_in, r, bias, dy = (torch.from_numpy(a).double() for a in
                             _slstm_inputs(6, 2, 32, 2, 8, False))
        h, traj = ref.slstm_cell_fwd_traj_ref(g_in, r, bias)
        want = ref.slstm_cell_bwd_ref(traj, h, r, dy)
        got = fn(traj, h, r, dy)
    assert _outside(got, want)


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("Bz", [1, 2, 3])
def test_slstm_param_partials_add_up_to_the_parameter_gradients(Bz, rows):
    """The per-cluster partial sums the backward kernel writes (clusters
    of ``rows`` batch rows, the last one short where ``rows`` does not
    divide B) add up over the clusters to ``slstm_param_grads``, and so
    to the reference's dR and db."""
    g_in, r, bias, dy = _slstm_inputs(40 + Bz, Bz, 12, 2, 8, False)
    _, vjp = jax.vjp(_jscan, g_in, r, bias)
    _, want_dr, want_db = vjp(dy)
    h, traj = ref.slstm_cell_fwd_traj_ref(
        *(torch.from_numpy(a).double() for a in (g_in, r, bias)))
    dgg = ref.slstm_cell_bwd_ref(traj, h, torch.from_numpy(r).double(),
                                 torch.from_numpy(dy).double())[0]
    dr_part, db_part = ref.slstm_param_partials_ref(h, dgg, rows)
    clusters = -(-Bz // rows)
    assert dr_part.shape == (clusters, 2, 8, 4, 8)
    assert db_part.shape == (clusters, 4, 2, 8)
    dr, db = ref.slstm_param_grads(h, dgg, torch.float64)
    for part, full in ((dr_part, dr), (db_part, db)):
        assert float((part.sum(0) - full).abs().max()) <= \
            1e-12 * float(full.abs().max())
    _hold((dr_part.sum(0).float(), db_part.sum(0).float()),
          (want_dr, want_db))


@pytest.mark.parametrize("dh", [4, 16, 64, 192, 256])
def test_slstm_bwd_staging_term_follows_the_kernel(dh):
    """The backward rule's staging term, written out from the kernel's
    shared-memory traffic: r once a (batch row, head), then per step, row
    and unit two warps' recurrent sums, 4 gate gradients into each of the
    cluster's 6 (8 above dh 192) blocks, and 9 inputs copied ahead."""
    B, S, H = 2, 8, 3
    got = kernelcost.slstm_cell_bwd_cost(
        f32(B, S, slstm_cell.TRAJ_ROWS, H, dh), f32(B, S, H, dh),
        f32(H, dh, 4, dh), f32(B, S, H, dh))
    blocks = 8 if dh > 192 else 6
    assert slstm_cell.cluster_blocks(dh) == blocks
    assert got["f_vmem_contig_float32_store"] == \
        B * H * 4 * dh * dh + B * S * H * dh * (2 + 4 * blocks + 9)


def test_slstm_backward_entry_takes_h_and_the_partials():
    """The backward's C entry point takes the forward's h and the two
    partial-sum outputs beside traj, r, dy and dgg, and its ctypes
    signature has as many arguments."""
    text = (_build.CSRC / "slstm_cell_bwd.cu").read_text()
    head = text[text.index('extern "C" int repro_slstm_cell_bwd_f32('):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == ["traj", "h", "r_gates", "dy", "dgg", "dr_part",
                     "db_part", "batch", "steps", "heads", "dh", "cs",
                     "rows", "stream"]
    assert len(_build.SIGNATURES["repro_slstm_cell_bwd_f32"]) == len(names)


def test_slstm_bwd_bound_counts_the_dot_and_dr():
    """``chip_smoke.slstm_bwd_bound_ms`` at xlstm-125m's layer (B 8, S
    4096, H 4, dh 192, 4 clusters a head): the transposed recurrence and
    dR, 2 × 2·B·S·H·dh·4dh = 77.3 GFLOP at 67 TFLOP/s, bound it above the
    bytes (traj, h, dy in, dgg out, r once, the clusters' partials)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    B, S, H, dh, clusters = 8, 4096, 4, 192, 4
    ms, by = chip_smoke.slstm_bwd_bound_ms(B, S, H, dh, clusters)
    ops = 2 * 2 * B * S * H * dh * 4 * dh
    assert (ms, by) == (ops / 67e12 * 1e3, "operations")
    assert abs(ops / 1e9 - 77.3) < 0.05 and abs(ms - 1.154) < 5e-4
    nbytes = 4 * (B * S * H * dh * 13 + H * dh * 4 * dh
                  + clusters * H * (dh * 4 * dh + 4 * dh))
    assert nbytes / 3.35e12 * 1e3 < ms
