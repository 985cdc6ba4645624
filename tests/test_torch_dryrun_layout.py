"""The dry-run's layouts of the MoE experts, the position tables and the
one-token lookup, held cell by cell against the reference's compiled
dry-run (``tools/dryrun_parity.py``, 2 layers, full width), and on gloo
meshes.

* The MoE training step on the reference's expert-parallel layout
  (``sharding.gated_experts``): each rank keeps its own experts, no
  collective crosses the model axis with an expert's weight or
  activation, no expert activation is all-gathered or reduce-scattered,
  the experts' weights are gathered over their d_model shards as often
  as the reference's program gathers them, the wire bytes (named
  differences out) within :data:`MEMORY_BAND` and the FLOPs within
  :data:`BAND`.
* Position tables sized by the rows a rank holds: no rank computes a
  sinusoid or RoPE angle table over the global batch; whisper-tiny
  ``prefill_32k``'s temporaries within :data:`MEMORY_BAND` (4.3× / 8.4×
  before).
* The one-token lookup reads the table's d_model shards
  (``sharding.lookup_table``): xlstm-125m ``long_500k`` gathers no block
  of the table (4.5 MB a device before).
* On a gloo (2, 4) mesh in 8 processes, ``apply_moe`` on each of the
  expert layouts equals the mesh-less port and the reference's
  ``jax.value_and_grad``; on the CPU, the forward with the new tables
  equals the reference's.
"""
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import moe_schema as jmoe_schema
from repro.models.param import init_tree as jinit_tree
from repro_torch.configs import SHAPES_BY_NAME, get_config, get_smoke_config
from repro_torch.core.opcost import OpRecorder
from repro_torch.models import lm
from repro_torch.models.param import carry

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_memory_tests = _load("_dryrun_memory_tests",
                      ROOT / "tests" / "test_torch_dryrun_memory.py")
_models_tests = _load("_models_tests",
                      ROOT / "tests" / "test_torch_models.py")
BAND, MEMORY_BAND = _memory_tests.BAND, _memory_tests.MEMORY_BAND
LAYOUT_DIFFERENCES = _memory_tests.LAYOUT_DIFFERENCES
_memory_ratios = _memory_tests._memory_ratios
_in_band = _memory_tests._in_band
_row, _wire = _memory_tests._row, _memory_tests._wire
run_ranks, TOL = _memory_tests.run_ranks, _memory_tests.TOL

MOE_CELLS = [("arctic-480b", "single"), ("deepseek-v2-236b", "pod2")]


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


def _shapes(c):
    return [d for _, d in c["in"] + c["out"]]


def _experts(arch):
    """(experts a rank on the 16-way model axis, d_model, the experts'
    hidden width) of ``arch``."""
    cfg = get_config(arch)
    return cfg.moe.num_experts // 16, cfg.d_model, cfg.moe.d_ff_expert


def _expert_weight(c, arch) -> bool:
    """A collective of a rank's experts' block of ``w_gate`` / ``w_up``
    ([e, D or a block of it, F]) or ``w_down`` ([e, F, D or a block])."""
    e, d, f = _experts(arch)
    return any(len(s) == 3 and s[0] == e and f in s[1:]
               and d % s[1 if s[2] == f else 2] == 0 for s in _shapes(c))


def _expert_activation(c, arch) -> bool:
    """A collective of a rank's experts' hidden ([e, C or a block of
    it, F]: a middle dimension no block of d_model)."""
    e, d, f = _experts(arch)
    return any(len(s) == 3 and s[0] == e and s[2] == f and d % s[1] != 0
               for s in _shapes(c))


def _backward_pass(c) -> bool:
    """A reference collective in its backward pass: the remat's
    recompute or the gradient's products."""
    name = c.get("op_name", "")
    return "rematted_computation" in name or name.startswith("checkpoint/")


@pytest.mark.parametrize("arch,mesh", MOE_CELLS)
def test_moe_experts_stay_on_their_ranks(rows, arch, mesh):
    """No collective moves an expert's weight or activation over the
    model axis (each rank keeps its 8 / 10 experts), and none
    all-gathers or reduce-scatters an expert activation [e, C, F]: the
    hidden's partial sums over d_model blocks are all-reduced where the
    capacity does not split over the batch axes, as in the reference's
    program (before: [8, 161, 4864] all-gathered 64 and reduce-scattered
    96 times at arctic-480b)."""
    port = rows(arch, "train_4k", mesh)["port"]
    crossing = [c for c in port["all_collectives"]
                if c.get("axis") == "model" and (
                    _expert_weight(c, arch) or _expert_activation(c, arch))]
    assert not crossing, crossing
    moved = [c for c in port["all_collectives"]
             if c["kind"] in ("all-gather", "reduce-scatter")
             and _expert_activation(c, arch)]
    assert not moved, moved


@pytest.mark.parametrize("arch,mesh", MOE_CELLS)
def test_moe_expert_weights_gathered_as_often_as_the_reference(
        rows, arch, mesh):
    """Each expert weight's all-gather over its d_model shards, by
    signature (the rank's block and the gathered width), runs twice as
    often in the port as in the reference's backward pass: once in the
    forward and once in the remat a microbatch and layer.  (XLA hoists
    the first forward's gathers out of its microbatch loop where one MoE
    layer is cut, at deepseek-v2-236b: those count once a step.)  At
    arctic-480b w_down [8, 4864, 448] → [8, 4864, 7168] 32 times (64
    before, the gate's and up's partial sums all-reduced); at
    deepseek-v2-236b the three weights, w_down kept gathered for dh."""
    row = rows(arch, "train_4k", mesh)

    def counts(side):
        got = {}
        for c in row[side]["all_collectives"]:
            if c["kind"] != "all-gather" or not _expert_weight(c, arch) \
                    or side == "reference" and not _backward_pass(c):
                continue
            key = tuple(c["in"][0][1])
            got[key] = got.get(key, 0) + c["count"]
        return got
    want = {k: 2 * n for k, n in counts("reference").items()}
    assert want and counts("port") == want, (counts("port"), want)


@pytest.mark.parametrize("arch,mesh", MOE_CELLS)
def test_moe_train_wire_and_flops_in_band(rows, arch, mesh):
    """Wire bytes with :data:`LAYOUT_DIFFERENCES` out of both sides
    within :data:`MEMORY_BAND` (2.39× at arctic-480b single and 2.24× at
    deepseek-v2-236b pod2 before), walked and product FLOPs within
    :data:`BAND`."""
    row = rows(arch, "train_4k", mesh)
    lo, hi = MEMORY_BAND
    assert lo <= _memory_ratios(row)["wire_bytes"] <= hi, \
        _memory_ratios(row)
    _in_band(row)


@pytest.mark.parametrize("mesh", ["single", "pod2"])
def test_position_tables_are_one_row(rows, mesh):
    """whisper-tiny ``prefill_32k``: the sinusoid (decoder and encoder)
    is computed on [1, S, d] and broadcast, so no ``aten.sin`` /
    ``aten.cos`` / ``aten.cat`` result has the global batch (32) as its
    first dimension, and the temporaries are within :data:`MEMORY_BAND`
    (4.08e9 B a device before: the [32, 32768, 384] f32 table and its
    halves)."""
    row = rows("whisper-tiny", "prefill_32k", mesh)
    batch = SHAPES_BY_NAME["prefill_32k"].global_batch
    ops = json.loads(Path(row["port"]["ops_path"]).read_text())["ops"]
    wide = [e for e in ops if e["op"] in ("aten.sin", "aten.cos", "aten.cat")
            and any(len(s) >= 3 and s[0] == batch for _, s in e["out"])]
    assert not wide, wide
    lo, hi = MEMORY_BAND
    assert lo <= row["ratio"]["temp_bytes"] <= hi, row["ratio"]


def _mlstm_state_heads(side) -> float:
    """A side's wire bytes of all-gathers of the mLSTM decode's f32
    state C per head (5-D blocks of [dh, dh], dh = 384 at xlstm-125m),
    at 2 bytes an element as :data:`LAYOUT_DIFFERENCES` counts f32."""
    return _wire(side, lambda c: c["kind"] == "all-gather"
                 and len(c["out"][0][1]) == 5
                 and c["out"][0][1][-1] == c["out"][0][1][-2] == 384) / 2


def _named_out(side, which) -> float:
    """A side's wire bytes with :data:`LAYOUT_DIFFERENCES` out (``which``:
    0, the reference's side; 1, the port's)."""
    return side["wire_bytes"] - sum(fs[which](side) for fs in
                                    LAYOUT_DIFFERENCES.values())


@pytest.mark.parametrize("mesh", ["single", "pod2"])
def test_one_token_lookup_reads_the_table_shards(rows, mesh):
    """xlstm-125m ``long_500k`` (one token): the lookup reads each
    rank's d_model block of the table's rows and gathers the row's
    blocks, as the reference's program does ([1, 1, 48] → [1, 1, 768]);
    no collective moves a block of the table [3144, 768 / n] (before: the
    table's FSDP shards all-gathered, 4.5 MB of the port's 4.9 MB a
    device).  The reference all-gathers the mLSTM's f32 state C per head
    (2.2 of its 2.7 MB) where the port keeps C's columns split: with
    those out of both sides the wire is within :data:`MEMORY_BAND`."""
    row = rows("xlstm-125m", "long_500k", mesh)
    ref, port = row["reference"], row["port"]
    table = [c for c in port["all_collectives"]
             if any(len(s) == 2 and s[0] == 50304 // 16 for s in _shapes(c))]
    assert not table, table
    assert _mlstm_state_heads(ref) > 0.25 * ref["wire_bytes"]
    r = _named_out(ref, 0) - _mlstm_state_heads(ref)
    p = _named_out(port, 1) - _mlstm_state_heads(port)
    lo, hi = MEMORY_BAND
    assert lo <= p / r <= hi, (p, r)


# ---------------------------------------------------------------------------
# gloo meshes
# ---------------------------------------------------------------------------

MOE_BODY = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.models.moe import apply_moe, moe_schema
from repro_torch.models.param import axes_tree, carry, tree_map
from repro_torch.sharding import DEFAULT_RULES, local, use_mesh

cfg = get_smoke_config("deepseek-v2-236b")
tree = {}
for key, arr in data.items():
    if key.startswith("p/"):
        node = tree
        *path, leaf = key[2:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
x, dy = torch.from_numpy(data["x"]), torch.from_numpy(data["dy"])
rules = dict(DEFAULT_RULES, expert_cap=None) if int(data["idle"]) else None
full = lambda u: u.full_tensor() if hasattr(u, "full_tensor") else u


def leaves(t, prefix=""):
    if isinstance(t, dict):
        return [v for k in sorted(t) for v in leaves(t[k], prefix + k + "/")]
    return [(prefix[:-1], t)]


def step(params, xx, dyy):
    params = tree_map(lambda u: u.detach().requires_grad_(), params)
    y, aux = apply_moe(params, cfg, xx)
    loss = (y * dyy).sum() + aux["moe_aux_loss"]
    named = leaves(params)
    grads = torch.autograd.grad(loss, [xx] + [u for _, u in named])
    return y, grads, [k for k, _ in named]


seen = []
apply = local._GatedExperts.apply
local._GatedExperts.apply = lambda *a: seen.append(a[5:]) or apply(*a)
xs = x.clone().requires_grad_()
y, grads, names = step(carry(tree, "cpu"), xs, dy)
params = carry(tree, "cpu", axes=axes_tree(moe_schema(cfg)), mesh=mesh)
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()
with use_mesh(mesh, rules), implicit_replication():
    dyd = distribute_tensor(dy, mesh, [Shard(0), Replicate()])
    ym, mgrads, _ = step(params, xd, dyd)
out["layout"] = np.array([len(seen)] + [len(v) if isinstance(v, list)
                                        else int(v) for v in seen[0]])
out["experts_split"] = np.array(
    [params["w_up"].placements[1] == Shard(0)])
out["y"], out["y_mesh"] = y.detach().numpy(), full(ym).detach().numpy()
for k, g, h in zip(["x"] + names, grads, mgrads):
    out["g/" + k], out["gm/" + k] = g.numpy(), full(h).numpy()
"""

#: (rules, batch, seq) → the path ``gated_experts`` takes on the (2, 4)
#: mesh (split dims, idle dims, gather) at the smoke width (d_model 64)
MOE_LAYOUTS = {
    # the capacity (72) splits over the data axis: weights gathered
    "capacity split": (0, 4, 16, [1, 1, 0, 1]),
    # the capacity (16) whole, 64 ≥ 2 × 16: contract over d_model blocks
    "capacity whole, partial sums": (1, 2, 4, [1, 0, 1, 0]),
    # the capacity (72) whole, 64 < 2 × 72: the weights gathered
    "capacity whole, weights gathered": (1, 4, 16, [1, 0, 1, 1]),
}


@functools.lru_cache(maxsize=None)
def _moe_reference(b, s):
    """The reference's (params, x, dy, y, gradients) of
    ``sum(y * dy) + aux loss`` for deepseek-v2-236b's smoke MoE."""
    cfg = jget_smoke("deepseek-v2-236b")
    p = jinit_tree(jax.random.PRNGKey(0), jmoe_schema(cfg), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (b, s, cfg.d_model))
    dy = jax.random.normal(jax.random.PRNGKey(2), (b, s, cfg.d_model))

    def loss(pp, xx):
        y, aux = japply_moe(pp, cfg, xx)
        return jnp.sum(y * dy) + aux["moe_aux_loss"], y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(p, x)
    flat = _memory_tests._mesh_tests._flat
    return flat(p), np.asarray(x), np.asarray(dy), np.asarray(y), \
        {"x": np.asarray(gx), **flat(gp)}


@pytest.mark.parametrize("layout", sorted(MOE_LAYOUTS))
def test_moe_layouts_match_the_mesh_less_port_and_the_reference(
        tmp_path, layout):
    """deepseek-v2-236b's smoke MoE (8 experts, 2 a rank over the model
    axis; a shared expert) on a gloo (2, 4) mesh, tokens split on the
    data axis: on each of :data:`MOE_LAYOUTS`' paths its output and the
    gradients of ``sum(y · dy) + aux`` for x and every parameter equal
    the mesh-less port's and the reference's ``jax.value_and_grad`` at
    :data:`TOL`."""
    idle, b, s, path = MOE_LAYOUTS[layout]
    p, x, dy, y_ref, g_ref = _moe_reference(b, s)
    got = run_ranks(tmp_path, (2, 4), ("data", "model"), MOE_BODY, {
        **{f"p/{k}": v for k, v in p.items()}, "x": x, "dy": dy,
        "idle": np.array(idle)})
    assert list(got["layout"]) == path, got["layout"]
    assert got["experts_split"].all()
    np.testing.assert_allclose(got["y_mesh"], got["y"], **TOL)
    np.testing.assert_allclose(got["y"], y_ref, **TOL)
    for k, want in g_ref.items():
        np.testing.assert_allclose(got["gm/" + k], got["g/" + k], **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(got["g/" + k], want, **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the position tables on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-tiny", "yi-6b"])
def test_forward_with_one_row_tables_matches_the_reference(arch):
    """At the smoke config, batch 4: the forward's logits equal the
    reference's (``tests/test_torch_models.py``'s tolerance), and every
    sinusoid / RoPE angle table the port computes (``aten.sin``,
    ``aten.cos``) has one row where the batch has four."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    batch = _models_tests.make_batch(cfg, seed=3, b=4, s=16)
    want, _, _ = jax.jit(lambda p, bb: jlm.forward(p, jcfg, bb,
                                                   mode="train"))(
        params, _models_tests.to_jax(batch))
    rec = OpRecorder()
    with rec:
        got, _, _ = lm.forward(carry(jax.tree.map(np.asarray, params),
                                     "cpu"), cfg,
                               _models_tests.to_torch(batch), mode="train")
    tables = [e["out"][0][1] for e in rec.entries()
              if e["op"] in ("aten.sin", "aten.cos")]
    assert tables and all(s[0] == 1 for s in tables), tables
    assert _models_tests._rel(got.detach().numpy(),
                              np.asarray(want)) < _models_tests.REL
