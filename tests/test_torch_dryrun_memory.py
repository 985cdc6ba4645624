"""The dry-run's temporaries and collective wire bytes held against the
reference's compiled dry-run (``tools/dryrun_parity.py``), and the layouts
behind them.

* gemma2-9b ``train_4k`` on 16 × 16: the training loss's logsumexp runs on
  each rank's vocabulary block (``sharding.logsumexp``), so no collective
  gathers a block of the f32 logits (before: 4 all-gathers of the whole
  microbatch, 63 of 64.6 GB of all-gather wire a device); the all-gather
  wire is under 2 GB, the temporaries at most 2× the reference's, the
  FLOPs in :data:`BAND`.
* Dense prefill: the wire bytes are within :data:`MEMORY_BAND` of the
  reference's once each difference named in :data:`LAYOUT_DIFFERENCES`
  is taken out of both sides, and each entry takes out something.
* xlstm-125m ``long_500k`` (one sequence, the batch axes idle): walked
  and product FLOPs within :data:`BAND` on both meshes.
* On gloo meshes in several processes: the vocabulary-parallel logsumexp
  and gemma2-9b's smoke loss with every parameter gradient equal the
  mesh-less step, and the reference's logsumexp; an xlstm decode step at
  batch 1 with its split products equals the mesh-less step.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_parity_tests = _load("_dryrun_parity_tests",
                      ROOT / "tests" / "test_torch_dryrun_parity.py")
_mesh_tests = _load("_mesh_tests", ROOT / "tests" / "test_torch_mesh.py")
BAND, PRICING = _parity_tests.BAND, _parity_tests.PRICING
_row, _in_band = _parity_tests._row, _parity_tests._in_band
run_ranks, TOL = _mesh_tests.run_ranks, _mesh_tests.TOL

#: port ÷ reference, per device, temporaries and collective wire bytes
MEMORY_BAND = (0.5, 2.0)


def _in_attention_loop(c) -> bool:
    """A reference collective of a K/V chunk inside its chunked
    attention's query-chunk loop (``op_name`` ``while/body/
    dynamic_slice``)."""
    return c.get("op_name", "").endswith("while/body/dynamic_slice")


def _slstm_step_reduce(c) -> bool:
    """A reference all-reduce of the sLSTM's recurrent-weight gradient
    inside its scan (``op_name`` ``bhd,hdge->bghe/dot_general``, one a
    step)."""
    return c["kind"] == "all-reduce" and \
        c.get("op_name", "").endswith("bhd,hdge->bghe/dot_general")


#: a MoE dispatch buffer's least rows (experts × capacity, or every
#: token of the batch) and width (a MoE model's d_model); no weight or
#: activation block of the sweep is 2-D with as many of both
DISPATCH = (1 << 17, 1024)


def _dispatch(c) -> bool:
    """A collective with a 2-D operand or result of a MoE dispatch
    buffer's size (:data:`DISPATCH`)."""
    rows, width = DISPATCH
    return any(len(d) == 2 and d[0] >= rows and d[1] >= width
               for _, d in c["in"] + c["out"])


#: the collectives the entries below take out whole
_WHOLE = (_in_attention_loop, _slstm_step_reduce, _dispatch)


def _wire(side, pred) -> float:
    """A side's wire bytes of the collectives ``pred`` holds for."""
    return sum(c["wire"] for c in side["all_collectives"] if pred(c))


def _f32_half(side) -> float:
    """Half the wire bytes of a side's f32 collectives that no entry
    takes out whole."""
    return _wire(side, lambda c: c["in"][0][0] in ("f32", "float32")
                 and not any(f(c) for f in _WHOLE)) / 2


#: collectives each side moves differently for the same work, by name:
#: (the reference's, the port's) wire bytes as functions of a side's row,
#: taken out of both sides' wire bytes before :data:`MEMORY_BAND` (the
#: entries take out disjoint collectives); each entry with the cell that
#: shows it (:data:`DIFFERENCE_CELLS`).
LAYOUT_DIFFERENCES = {
    # The reference's CPU compile widens the bf16 activations to f32
    # around its collectives (the widening PRICING names for its FLOPs):
    # its all-reduces after the row-parallel products move f32 where the
    # port's move bf16.  Both sides' f32 collectives count at 2 bytes an
    # element, the port's (the loss's reductions, recurrent states) too.
    "f32 collectives at bf16 width": (_f32_half, _f32_half),
    # The reference's chunked attention reads the sequence-split K/V
    # cache inside its query-chunk loop, gathering (MLA: all-to-all) a
    # K/V chunk at every step (128 at gemma2-9b prefill, 64.4 of 79.1 GB
    # a device); the port's attention kernel takes the K/V gathered once
    # a layer, which stays in.
    "the attention loop's K/V collectives": (
        lambda side: _wire(side, _in_attention_loop),
        lambda side: _wire(side, _in_attention_loop)),
    # The reference's sLSTM scan all-reduces the recurrent weight's
    # gradient at each of its 4096 steps (18.2 of 28.4 GB a device at
    # xlstm-125m train_4k); the port's backward kernel sums it over the
    # steps and reduces it once, which stays in.
    "the sLSTM's recurrent gradient, reduced each step": (
        lambda side: _wire(side, _slstm_step_reduce),
        lambda side: _wire(side, _slstm_step_reduce)),
    # The scatter dispatch: the reference scatters each rank's tokens
    # into a whole f32 dispatch buffer and all-reduces it over the model
    # axis; the port all-gathers the tokens and their slots (bf16) and
    # each rank fills its experts' part.
    "the MoE dispatch buffer": (lambda side: _wire(side, _dispatch),
                                lambda side: _wire(side, _dispatch)),
}
DIFFERENCE_CELLS = {
    "f32 collectives at bf16 width": ("gemma2-9b", "train_4k"),
    "the attention loop's K/V collectives": ("gemma2-9b", "prefill_32k"),
    "the sLSTM's recurrent gradient, reduced each step": ("xlstm-125m",
                                                          "train_4k"),
    "the MoE dispatch buffer": ("deepseek-v2-236b", "prefill_32k"),
}


def _memory_ratios(row) -> dict:
    """port ÷ reference temporaries, and wire bytes with
    :data:`LAYOUT_DIFFERENCES` taken out of both sides."""
    ref, port = row["reference"], row["port"]
    r = ref["wire_bytes"] - sum(f(ref) for f, _ in
                                LAYOUT_DIFFERENCES.values())
    p = port["wire_bytes"] - sum(g(port) for _, g in
                                 LAYOUT_DIFFERENCES.values())
    return {"temp_bytes": row["ratio"]["temp_bytes"], "wire_bytes": p / r}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """The parity row of a cell, each computed once for the module."""
    out = tmp_path_factory.mktemp("parity")
    memo = {}

    def get(arch, shape, mesh="single"):
        if (arch, shape, mesh) not in memo:
            memo[arch, shape, mesh] = _row(out / f"{arch}_{shape}_{mesh}",
                                           arch, shape, mesh)
        return memo[arch, shape, mesh]
    return get


def test_train_loss_keeps_the_logits_on_their_ranks(rows):
    """gemma2-9b ``train_4k`` on 16 × 16 (2 layers): the loss's
    logsumexp reduces each rank's vocabulary block and all-reduces the
    max and the sums over the model axis (f32 [4, 4096] a microbatch);
    no collective moves a block of the logits [4, 4096, 16000]; the
    all-gather wire is under 2 GB (the table's and the FSDP weights'),
    the temporaries within 2× the reference's (53.3e9 B before, 4.0×),
    walked and product FLOPs within :data:`BAND`."""
    row = rows("gemma2-9b", "train_4k")
    port = row["port"]
    vocab = 256000
    assert not [c for c in port["all_collectives"]
                if len(c["in"][0][1]) == 3
                and c["in"][0][1][-1] in (vocab, vocab // 16)]
    assert any(c["kind"] == "all-reduce" and c["in"] == [
        ["float32", [4, 4096]]] for c in port["all_collectives"])
    assert port["wire_by_kind"]["all-gather"] < 2e9
    assert row["ratio"]["temp_bytes"] <= MEMORY_BAND[1]
    _in_band(row)


def test_dense_prefill_wire_in_band_once_the_named_layouts_are_out(rows):
    """gemma2-9b ``prefill_32k`` on 16 × 16: the raw wire bytes are
    0.085× the reference's; with :data:`LAYOUT_DIFFERENCES` out of both
    sides they are within :data:`MEMORY_BAND`, as are the temporaries."""
    row = rows("gemma2-9b", "prefill_32k")
    assert not MEMORY_BAND[0] <= row["ratio"]["wire_bytes"] <= \
        MEMORY_BAND[1]
    lo, hi = MEMORY_BAND
    for key, v in _memory_ratios(row).items():
        assert lo <= v <= hi, (key, v)


@pytest.mark.parametrize("name", sorted(LAYOUT_DIFFERENCES))
def test_layout_differences_are_the_named_collectives(rows, name):
    """Each :data:`LAYOUT_DIFFERENCES` entry takes out of its cell
    (:data:`DIFFERENCE_CELLS`) a tenth of the reference's wire bytes or
    more, and never more than a side's whole wire."""
    row = rows(*DIFFERENCE_CELLS[name])
    ref_out, port_out = LAYOUT_DIFFERENCES[name]
    ref, port = row["reference"], row["port"]
    assert 0.1 * ref["wire_bytes"] <= ref_out(ref) <= ref["wire_bytes"]
    assert 0 <= port_out(port) <= port["wire_bytes"]


@pytest.mark.parametrize("mesh", ["single", "pod2"])
def test_one_sequence_splits_the_xlstm_products(rows, mesh):
    """xlstm-125m ``long_500k`` (batch 1: the batch axes hold nothing):
    the mLSTM's q, k, v run on one repeat of one head a rank over the
    data axis and C's columns split there, the sLSTM's recurrent (192,
    192) blocks one (gate, head) a rank over the model axis, and on 16 ×
    16 the gates' 3072 outputs over it too — walked FLOPs (``PRICING``
    out) and product FLOPs within :data:`BAND` (before: 2.6× and 3.3×)."""
    _in_band(rows("xlstm-125m", "long_500k", mesh))


# ---------------------------------------------------------------------------
# gloo meshes
# ---------------------------------------------------------------------------

LOSS_BODY = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.models.param import place, tree_map
from repro_torch.sharding import logsumexp, use_mesh

t = {k: torch.from_numpy(v) for k, v in data.items()}
R = Replicate()
full = lambda u: u.full_tensor() if hasattr(u, "full_tensor") else u

# (a) logits split on the batch (data) and the vocabulary (model)
x = distribute_tensor(t["lf"], mesh, [Shard(0), Shard(2)]).requires_grad_()
z = logsumexp(x)
dz = distribute_tensor(t["dz"], mesh, list(z.placements))
(gx,) = torch.autograd.grad((z * dz).sum(), [x])
out["lse"] = full(z).detach().numpy()
out["lse_grad"] = full(gx).numpy()
out["lse_layout"] = np.array([tuple(z.placements) == (Shard(0), R),
                              tuple(gx.placements) == (Shard(0), Shard(2))])

# (b) gemma2-9b's smoke loss and every parameter gradient
cfg = get_smoke_config("gemma2-9b")
params = lm.init(torch.Generator().manual_seed(3), cfg, device="cpu")
tokens = t["tokens"]
batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}


def leaves(tree):
    if isinstance(tree, dict):
        return [u for k in sorted(tree) for u in leaves(tree[k])]
    return [tree]


def step(p, b):
    p = tree_map(lambda u: u.detach().requires_grad_(), p)
    loss, _ = lm.lm_loss(p, cfg, b)
    return loss, torch.autograd.grad(loss, leaves(p))


loss, grads = step(params, batch)
with use_mesh(mesh), implicit_replication():
    placed = place(params, lm.param_axes(cfg), mesh)
    mloss, mgrads = step(placed, {k: distribute_tensor(v, mesh, [Shard(0), R])
                                  for k, v in batch.items()})
out["loss"] = np.array([float(loss), float(full(mloss))])
out["grads"] = np.array([np.allclose(full(g).numpy(), h.numpy(),
                                     rtol=2e-4, atol=2e-5)
                         for g, h in zip(mgrads, grads)])
out["vocab_split"] = np.array(
    [placed["embed"].placements[1] == Shard(0)])
"""


def test_vocabulary_parallel_loss_matches_the_mesh_less_step(tmp_path):
    """On a 2 × 2 gloo mesh: (a) ``sharding.logsumexp`` of f32 logits
    split on the batch (data) and the vocabulary (model), one of them
    1e4 in one rank's block, equals ``jax.scipy.special.logsumexp``
    (the reference's loss, ``src/repro/models/lm.py:307``) and its
    gradient the softmax, at :data:`TOL`, finite; it keeps the batch
    split and returns the vocabulary's ranks their own blocks'
    gradients.  (b) gemma2-9b's smoke loss (vocabulary 512 over the
    model axis) and every parameter gradient under the mesh, tokens
    split on the batch, equal the mesh-less step at :data:`TOL`."""
    rng = np.random.default_rng(7)
    lf = (rng.standard_normal((4, 8, 64)) * 3).astype(np.float32)
    lf[1, 3, 40] = 1e4        # the model axis's second block (32–63)
    dz = rng.standard_normal((4, 8)).astype(np.float32)
    tokens = rng.integers(0, 512, (4, 16)).astype(np.int64)
    got = run_ranks(tmp_path, (2, 2), ("data", "model"), LOSS_BODY,
                    {"lf": lf, "dz": dz, "tokens": tokens})
    want = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(lf), axis=-1))
    soft = np.asarray(jax.nn.softmax(jnp.asarray(lf), axis=-1))
    assert np.isfinite(got["lse"]).all() and np.isfinite(
        got["lse_grad"]).all()
    np.testing.assert_allclose(got["lse"], want, **TOL)
    np.testing.assert_allclose(got["lse_grad"], soft * dz[..., None], **TOL)
    assert got["lse_layout"].all(), got["lse_layout"]
    plain, meshed = got["loss"]
    np.testing.assert_allclose(meshed, plain, **TOL)
    assert got["grads"].all(), got["grads"]
    assert got["vocab_split"].all()


DECODE_BODY = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, xlstm
from repro_torch.models.param import place, tree_map
from repro_torch.sharding import use_mesh

base = get_smoke_config("xlstm-125m")
cfg = dataclasses.replace(base, xlstm=dataclasses.replace(base.xlstm,
                                                          num_heads=2))
params = lm.init(torch.Generator().manual_seed(5), cfg, device="cpu")
prompt = torch.from_numpy(data["prompt"])
tok = torch.from_numpy(data["tok"])
cache, _ = lm.prefill(params, cfg, lm.zero_cache(cfg, 1, 32),
                      {"tokens": prompt})
clone = lambda c: tree_map(lambda u: u.clone(), c)
want_cache, want = lm.decode_step(params, cfg, clone(cache), tok, 16)
full = lambda u: u.full_tensor() if hasattr(u, "full_tensor") else u


def leaves(tree):
    if isinstance(tree, dict):
        return [u for k in sorted(tree) for u in leaves(tree[k])]
    return [tree]


def ok(got, ref):
    return bool(np.allclose(full(got).detach().numpy(),
                            ref.detach().numpy(), rtol=2e-4, atol=2e-5))


for name, m in (("data4", mesh),
                ("model4", init_device_mesh("cpu", (2, 4),
                                            mesh_dim_names=("data",
                                                            "model")))):
    with use_mesh(m), implicit_replication():
        probe = distribute_tensor(torch.zeros(1, 1, cfg.d_model), m,
                                  [Replicate(), Replicate()])
        paths = [xlstm._idle_heads(2, probe), xlstm._gate_split(2, probe)]
        p = place(params, lm.param_axes(cfg), m)
        c = place(clone(cache), lm.cache_axes(cfg, 1, 32), m)
        new_cache, logits = lm.decode_step(p, cfg, c, tok, 16)
    out[name] = np.array([ok(logits, want)] + [
        ok(g, h) for g, h in zip(leaves(new_cache), leaves(want_cache))])
    out[name + "_paths"] = np.array([-1 if v is None else
                                     (v if isinstance(v, int) else v[0])
                                     for v in paths])
"""


def test_xlstm_decode_at_one_sequence_matches_the_mesh_less_step(tmp_path):
    """An xlstm decode step at batch 1 (two heads, smoke width) after a
    16-token prefill, in 8 gloo processes: on a (4, 2) mesh each mLSTM
    head is repeated twice over the idle data axis (q, k, v one repeat a
    rank, C's columns split there); on a (2, 4) mesh the model axis does
    not split the 2 heads but splits the sLSTM's 8 (gate, head) blocks,
    each rank one block's recurrent product and its block of the gates'
    outputs.  The logits and every leaf of the new cache equal the
    mesh-less step at :data:`TOL`."""
    rng = np.random.default_rng(9)
    got = run_ranks(tmp_path, (4, 2), ("data", "model"), DECODE_BODY, {
        "prompt": rng.integers(0, 512, (1, 16)).astype(np.int64),
        "tok": rng.integers(0, 512, (1, 1)).astype(np.int64)})
    assert list(got["data4_paths"]) == [2, -1]
    assert list(got["model4_paths"]) == [1, 1]
    assert got["data4"].all(), got["data4"]
    assert got["model4"].all(), got["model4"]
