"""The port's per-device op walker (``core/opcost.py``) and roofline
(``core/roofline.py``), against the reference's HLO walker and roofline.

Each walker test runs a JAX function through ``repro.core.hlo.
HloCostAnalyzer`` (jit on the CPU, as ``tests/test_hlo_analyzer.py``
does) and the same function in torch through ``OpRecorder`` and
``OpCostAnalyzer``.  Both are held to the closed form: the reference
with its own test's tolerance, the port exactly where eager execution
makes it so (every loop step is dispatched, every product priced by its
formula).  Bytes are compared with the closed form only, never across
the packages: XLA fuses and eager PyTorch does not.

Also: the record's structure and its JSON round trip; DTensor's sharding
propagation left out of the per-device walk (8 fake ranks, exact ÷ 8);
``RooflineRow.finish`` field for field against the reference's; a smoke
dry-run cell's record priced by ``roofline_table`` and the bench; and a
whole training step's dot-class FLOPs against the reference's compiled
step, each difference pinned by name (:data:`DOT_DIFFERENCES`).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hlo import HloCostAnalyzer, parse_hlo
from repro.core.roofline import RooflineRow as JRooflineRow
from repro_torch.core import roofline
from repro_torch.core.opcost import OpCostAnalyzer, OpRecorder, parse_ops

ROOT = Path(__file__).resolve().parents[1]


def _reference(fn, *specs, n_dev=1):
    txt = jax.jit(fn).lower(*specs).compile().as_text()
    return HloCostAnalyzer(txt, num_devices=n_dev).entry_cost()


def _walk(fn, *args, **kw):
    with OpRecorder() as rec:
        fn(*args)
    return OpCostAnalyzer(rec.to_json(), **kw), rec


def test_loop_flops_multiplied_by_the_steps():
    """Ten steps of tanh(c @ w) at 512² bf16: 10·2·512³ — the reference
    within its 2%, the port exactly (plus tanh's one a result element)."""
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=10)
        return y

    s = jax.ShapeDtypeStruct((512, 512), jnp.bfloat16)
    expect = 10 * 2 * 512 ** 3
    assert abs(_reference(f, s, s).flops - expect) / expect < 0.02

    def g(c, w):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    rng = np.random.default_rng(0)
    c, w = (torch.from_numpy(rng.standard_normal((512, 512)).astype(
        np.float32)).bfloat16() for _ in range(2))
    got = _walk(g, c, w)[0].entry_cost()
    assert got.flops == expect + 10 * 512 * 512
    assert got.transcendentals == 10 * 512 * 512
    assert abs(got.flops - expect) / expect < 0.02


def test_nested_loops_multiply():
    """3 × 4 steps of c·1.5 + 1.0 at 128²: 3·4·2·128² — the reference
    within its 35% (loop plumbing), the port exactly."""
    def f(x):
        def outer(c, _):
            def inner(ci, _):
                return ci * 1.5 + 1.0, None
            ci, _ = jax.lax.scan(inner, c, None, length=4)
            return ci, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y

    expect = 3 * 4 * 2 * 128 * 128
    ref = _reference(f, jax.ShapeDtypeStruct((128, 128), jnp.float32))
    assert abs(ref.flops - expect) / expect < 0.35

    def g(c):
        for _ in range(3):
            for _ in range(4):
                c = c * 1.5 + 1.0
        return c

    got = _walk(g, torch.zeros(128, 128))[0].entry_cost()
    assert got.flops == expect


def test_dot_flops_from_the_contracting_dims():
    """``einsum("bik,bkj->bij")`` at (4, 64, 96) × (4, 96, 32): the
    reference within its 5%, the port exactly (its permutes are views)."""
    expect = 2 * 4 * 64 * 32 * 96
    ref = _reference(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                     jax.ShapeDtypeStruct((4, 64, 96), jnp.float32),
                     jax.ShapeDtypeStruct((4, 96, 32), jnp.float32))
    assert abs(ref.flops - expect) / expect < 0.05
    walker, rec = _walk(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                        torch.zeros(4, 64, 96), torch.zeros(4, 96, 32))
    got = walker.entry_cost()
    assert got.flops == expect
    # the permutes and views einsum adds move no bytes: bmm's operands
    # and result only
    assert got.bytes == 4 * 4 * (64 * 96 + 96 * 32 + 64 * 32)


def test_one_row_a_step_costs_the_row_not_the_array():
    """Reading one row a step over 1024 steps of a 1024² f32 array costs
    less than the full array ÷ 50 a step and at least half of one full
    pass — in both packages (the port's slice is a view)."""
    full_per_step = 1024 * 1024 * 1024 * 4
    one_pass = 1024 * 1024 * 4

    def f(xs):
        def body(c, i):
            row = jax.lax.dynamic_slice(xs, (i, 0), (1, 1024))
            return c + jnp.sum(row), None
        c, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(1024))
        return c

    ref = _reference(f, jax.ShapeDtypeStruct((1024, 1024), jnp.float32))
    assert one_pass * 0.5 < ref.bytes < full_per_step / 50

    def g(xs):
        c = torch.zeros(())
        for i in range(1024):
            c = c + xs[i:i + 1].sum()
        return c

    got = _walk(g, torch.zeros(1024, 1024))[0].entry_cost()
    assert one_pass * 0.5 < got.bytes < full_per_step / 50
    # each step: the row read, a scalar written, a scalar add
    assert got.bytes == 4 + 1024 * (1024 * 4 + 4 + 3 * 4)


def test_the_record_holds_the_product_and_round_trips():
    """A walked tanh(a @ b) holds an ``mm`` entry (the reference's HLO a
    ``dot``), and the record priced from its JSON text equals the record
    priced from its entries."""
    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    comps, entry = parse_hlo(jax.jit(lambda a, b: jnp.tanh(a @ b))
                             .lower(s, s).compile().as_text())
    assert entry is not None
    assert any(op.opcode == "dot" for c in comps.values() for op in c.ops)

    walker, rec = _walk(lambda a, b: torch.tanh(a @ b), torch.zeros(64, 64),
                        torch.zeros(64, 64))
    text = rec.to_json()
    ops = parse_ops(text)
    mm = [e for e in ops if e["op"] == "aten.mm"]
    assert len(mm) == 1 and mm[0]["count"] == 1
    assert mm[0]["in"] == [["float32", [64, 64]]] * 2
    assert mm[0]["flops"] == 2 * 64 ** 3
    assert json.loads(text)["calls"] == rec.calls == 2
    assert parse_ops(json.dumps({"ops": ops})) == ops
    assert OpCostAnalyzer(rec.entries()).entry_cost().as_dict() == \
        walker.entry_cost().as_dict()


def test_a_kernel_launch_is_recorded_as_its_custom_op():
    """On the card the attention wrapper launches its kernel without
    dispatching the custom op; its launcher's report (made here by hand
    on host tensors) is recorded under the custom op's name with the
    custom op's FLOPs, operands and the launch's outputs (the output and
    its lse), and nothing listens outside a recording."""
    from repro_torch.kernels import _observe, ops

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, h, 32)).astype(
        np.float32)) for h in (4, 2, 2))
    with OpRecorder() as host:
        ops.flash_attention(q, k, v, causal=True, block_q=32, block_k=32)
    (want,) = [e for e in host.entries()
               if e["op"] == "repro_torch.flash_attention"]
    out, lse = torch.empty(1, 64, 4, 32), torch.empty(1, 4, 64)
    with OpRecorder() as card:
        _observe.launched("flash_attention", (q, k, v), (out, lse))
    assert _observe.observers == []
    assert card.entries() == [{
        "op": "repro_torch.flash_attention", "in": want["in"][:3],
        "out": [["float32", (1, 64, 4, 32)], ["float32", (1, 4, 64)]],
        "count": 1, "flops": want["flops"]}]
    assert want["flops"] == 2 * 4 * 64 * 64 * (32 + 32)


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _ssd_operands(rng):
    b, s, h, p, n = 1, 32, 2, 8, 4
    return (_f32(rng, b, s, h, p), -torch.rand(b, s, h), _f32(rng, b, s, h, n),
            _f32(rng, b, s, h, n))


def _slstm_operands(rng):
    b, s, h, dh = 2, 4, 2, 8
    return (_f32(rng, b, s, 4, h, dh), 0.1 * _f32(rng, h, dh, 4, dh),
            _f32(rng, 4, h, dh))

def _ssd_bwd_operands(rng):
    xdt, da, bm, cm = _ssd_operands(rng)
    return xdt, da, bm, cm, _f32(rng, *xdt.shape)


def _slstm_bwd_operands(rng):
    g, r, bg = _slstm_operands(rng)
    h, traj = torch.ops.repro_torch.slstm_cell_traj(g, r, bg)
    return traj, h, r, _f32(rng, *h.shape)


#: each model-layer kernel's custom op: its module, its launcher (which
#: takes the op's arguments) and the op's arguments made from a seed
LAUNCHERS = {
    "mamba2_ssd": ("mamba2_ssd", "mamba2_ssd_cuda",
                   lambda rng: (*_ssd_operands(rng), 16)),
    "mamba2_ssd_state": ("mamba2_ssd", "mamba2_ssd_state_cuda",
                         lambda rng: (*_ssd_operands(rng), 16)),
    "mamba2_ssd_bwd": ("mamba2_ssd", "mamba2_ssd_bwd_cuda",
                       lambda rng: (*_ssd_bwd_operands(rng), 16)),
    "slstm_cell": ("slstm_cell", "slstm_cell_cuda", _slstm_operands),
    "slstm_cell_state": ("slstm_cell", "slstm_cell_state_cuda",
                         _slstm_operands),
    "slstm_cell_traj": ("slstm_cell", "slstm_cell_traj_cuda",
                        _slstm_operands),
    "slstm_cell_bwd": ("slstm_cell", "slstm_cell_bwd_cuda",
                       _slstm_bwd_operands),
}


@pytest.mark.parametrize("op", sorted(LAUNCHERS))
def test_each_kernel_launch_report_matches_its_custom_op(op, monkeypatch):
    """The SSD's and the sLSTM's launchers report their launches as the
    attention's does: each launcher, run on host tensors with the launch
    itself stubbed out (no card here), is recorded as the same op, with
    the same operands in the same order and the same FLOPs, as the
    host's custom op dispatched on the same arguments (an operand out of
    order would price the kernel at other shapes)."""
    import importlib

    from repro_torch.kernels import _build

    module_name, launcher, make = LAUNCHERS[op]
    mod = importlib.import_module(f"repro_torch.kernels.{module_name}")
    monkeypatch.setattr(_build, "launch_on", lambda *args: None)
    for counter in ("launches", "backward_launches", "bwd_route_launches"):
        if hasattr(mod, counter):
            value = getattr(mod, counter)
            monkeypatch.setattr(mod, counter, dict(value)
                                if isinstance(value, dict) else value)
    if module_name == "slstm_cell":
        monkeypatch.setattr(mod, "_plan", lambda *args: {
            "cluster_blocks": 1, "rows_per_cluster": 1})
    args = make(np.random.default_rng(7))
    with OpRecorder() as host:
        getattr(torch.ops.repro_torch, op)(*args)
    (want,) = [e for e in host.entries()
               if e["op"] == f"repro_torch.{op}"]
    with OpRecorder() as card:
        getattr(mod, launcher)(*args)
    (got,) = [e for e in card.entries() if e["op"].startswith("repro_torch.")]
    assert (got["op"], got["in"], got["count"]) == \
        (want["op"], want["in"], 1)
    assert got["flops"] == want["flops"] > 0


# ---------------------------------------------------------------------------
# 8 ranks: the reference on 8 forced XLA host devices, the port on torch's
# fake process group — one subprocess for both (the device count and the
# group are per process)
# ---------------------------------------------------------------------------

_EIGHT_RANKS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.compat import make_mesh
from repro.core.hlo import HloCostAnalyzer

jmesh = make_mesh((8,), ("d",))
jf = jax.jit(jnp.sum, in_shardings=NamedSharding(jmesh, P("d")))
spec = jax.ShapeDtypeStruct((1024, 64), jnp.float32)
txt = jf.lower(spec).compile().as_text()
ref = HloCostAnalyzer(txt, num_devices=8).entry_cost()

import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.opcost import OpCostAnalyzer, OpRecorder

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
x = DTensor.from_local(torch.ones(128, 64), mesh, [Shard(0)],
                       run_check=False, shape=(1024, 64), stride=(64, 1))
w = DTensor.from_local(torch.ones(64, 32), mesh, [Replicate()],
                       run_check=False)
with OpRecorder() as summed:
    x.sum().full_tensor()
with OpRecorder() as product:
    x @ w
walk = OpCostAnalyzer(product.entries(), num_devices=8,
                      track_breakdown=True)
walk.entry_cost()
print(json.dumps({
    "reference": ref.as_dict(),
    "sum": OpCostAnalyzer(summed.entries(), num_devices=8).entry_cost()
           .as_dict(),
    "sum_ops": summed.entries(), "product_ops": product.entries(),
    "product_formula_flops": walk.formula_flops}))
dist.destroy_process_group()
"""


@functools.lru_cache(maxsize=None)
def _eight_ranks():
    proc = subprocess.run([sys.executable, "-c", _EIGHT_RANKS],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=120, env={**os.environ,
                                            "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collective_detection_and_wire_bytes():
    """The sum of a tensor sharded 8 ways gives at least one all-reduce
    in both packages, its wire bytes 2·(g − 1)/g × its payload (g = 8;
    the port's group size from the op's own group)."""
    out = _eight_ranks()
    for cost in (out["reference"], out["sum"]):
        ar = cost["collectives"]["all-reduce"]
        assert ar["count"] >= 1
        assert ar["wire"] == pytest.approx(2 * 7 / 8 * ar["payload"],
                                           rel=1e-12)
        assert cost["collective_wire_bytes"] > 0
    reduce = [e for e in out["sum_ops"]
              if e["op"] == "_c10d_functional.all_reduce"]
    assert reduce and all(e["group"] == 8 for e in reduce)


def test_sharding_propagation_is_not_counted():
    """A ``Shard(0)`` (1024, 64) @ (64, 32) on 8 ranks: the walk holds
    each rank's (128, 64) × (64, 32) product only — not DTensor's
    propagation of the global (1024, 64) one — so its FLOPs are the
    global product's ÷ 8 exactly."""
    out = _eight_ranks()
    mm = [e for e in out["product_ops"] if e["op"] == "aten.mm"]
    assert [e["in"] for e in mm] == [[["float32", [128, 64]],
                                      ["float32", [64, 32]]]]
    assert out["product_formula_flops"] == {
        "aten.mm": 2 * 1024 * 64 * 32 / 8}


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

#: per-device FLOPs, bytes, wire bytes, chips, MODEL_FLOPS: compute-,
#: memory- and collective-dominated rows, and an empty one
ROW_CASES = [(3.5e14, 2.0e11, 4.0e9, 256, 8.0e16),
             (2.2e12, 9.0e11, 1.0e9, 512, 1.1e15),
             (1.0e12, 1.0e10, 9.0e11, 8, 5.0e12),
             (0.0, 0.0, 0.0, 1, 0.0)]


@pytest.mark.parametrize("flops,nbytes,wire,chips,model", ROW_CASES)
def test_roofline_arithmetic_matches_the_reference(flops, nbytes, wire,
                                                   chips, model):
    """``RooflineRow.finish`` of both packages on the same inputs and the
    same hardware dict: every field equal (the dict holds the port's
    ``link_bw`` and, at the same rate, the reference's ``ici_bw``)."""
    hw = dict(roofline.H100_SXM, ici_bw=roofline.H100_SXM["link_bw"])
    kw = dict(arch="a", shape="s", mesh="single", chips=chips,
              hlo_flops=flops, hlo_bytes=nbytes, coll_wire_bytes=wire,
              model_flops_total=model)
    want = JRooflineRow(**kw).finish(hw).as_dict()
    got = roofline.RooflineRow(**kw).finish(hw).as_dict()
    assert got == want


def test_h100_constants_name_their_source():
    hw = roofline.H100_SXM
    assert (hw["peak_flops_bf16"], hw["hbm_bw"], hw["link_bw"],
            hw["hbm_bytes"]) == (989e12, 3.35e12, 450e9, 80e9)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in hw["source"]


def _dryrun(out: Path, *extra) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "train_4k", "--mesh", "single", "--smoke",
         "--out", str(out), *extra], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env={**os.environ,
                                    "PYTHONPATH": str(ROOT / "src")})
    rec = json.loads((out / "yi-6b__train_4k__single.json").read_text())
    assert proc.returncode == 0 and rec["status"] == "ok", \
        rec.get("traceback", proc.stderr[-3000:])
    return rec


_FULL_WIDTH_CELL = r"""
import dataclasses, sys
from pathlib import Path
sys.path.insert(0, "src")
import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_config
cfg = dataclasses.replace(get_config("gemma2-9b"), num_layers=2)
dryrun.get_smoke_config = lambda arch: cfg
rec = dryrun.run_cell("gemma2-9b", "train_4k", "single", Path(sys.argv[1]),
                      smoke=True)
sys.exit(0 if rec["status"] == "ok" else 1)
"""


def test_dryrun_splits_the_mlp_and_projections_as_the_rules_say(tmp_path):
    """gemma2-9b at full width, cut to 2 layers, on the 16 × 16 mesh:
    each rank runs the MLP's products at d_ff ÷ 16 and the query, key,
    value and output projections' at (16 heads · 256) ÷ 16 (the 8
    key/value heads repeated to 16, one a rank beside its query head),
    on its 16th of the batch — per device exactly the even split of the
    rules ("ff" and "heads" on "model", the batch on "data"), remat
    "full" giving each weight four products a microbatch (forward,
    recompute, input gradient, weight gradient) — and no product holds
    a width whole (the key/value heads' 8 · 256 neither); the attention
    kernel's FLOPs a rank are the record's at the global shapes ÷ 256.
    (A gradient reaching a layer's output partial on the model axis ran
    these products on gathered weights at full width; the key/value
    heads, replicated, ran every query head on every rank.)"""
    from repro_torch.core.opcost import product_flops
    proc = subprocess.run(
        [sys.executable, "-c", _FULL_WIDTH_CELL, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    rec = json.loads(
        (tmp_path / "gemma2-9b__train_4k__single.json").read_text())
    assert proc.returncode == 0, rec.get("traceback", proc.stderr[-3000:])
    ops = parse_ops(Path(rec["ops_path"]).read_text())
    tokens, d, layers, chips = 256 * 4096, 3584, 2, 256
    for width, weights in ((14336, 3), (16 * 256, 4)):
        assert product_flops(ops, width) == 0
        assert product_flops(ops, width // 16) == \
            weights * 4 * 2 * tokens * d * width * layers / chips
    assert product_flops(ops, 8 * 256) == 0
    kernels = ("repro_torch.flash_attention",
               "repro_torch.flash_attention_bwd")
    walked = sum(e["flops"] for e in ops if e["op"] in kernels)
    by_op = rec["cost"]["flops_by_op"]
    assert walked * chips == sum(by_op[op] for op in kernels) > 0


def test_smoke_dryrun_cell_gives_an_ok_row(tmp_path, monkeypatch):
    """``yi-6b train_4k single --smoke``: the record names its op program
    (``--no-ops`` leaves it out), ``roofline_table`` prices it from a
    moved directory into an ``ok`` row with three terms ≥ 0 and walked
    FLOPs × chips at least the record's global count (replicated work
    counts on every rank), and the bench prints its row."""
    rec = _dryrun(tmp_path / "dr")
    assert rec["ops_count"] > 0
    assert Path(rec["ops_path"]).name == "yi-6b__train_4k__single.ops.json"
    assert "ops_path" not in _dryrun(tmp_path / "bare", "--no-ops")
    moved = tmp_path / "runs" / "dryrun_torch"
    moved.parent.mkdir()
    (tmp_path / "dr").rename(moved)
    rows = roofline.roofline_table(str(moved), mesh="single")
    assert [r.status for r in rows] == ["ok"]
    row = rows[0]
    assert row.chips == 256
    assert min(row.t_compute, row.t_memory, row.t_collective) >= 0
    assert row.roofline_time == max(row.t_compute, row.t_memory,
                                     row.t_collective) > 0
    assert row.hlo_flops * row.chips >= rec["cost"]["flops"]
    assert row.coll_breakdown and 0 < row.useful_ratio <= 1
    assert row.hbm_gb_per_chip == \
        rec["memory"]["total_per_device_bytes"] / 2 ** 30
    assert roofline.format_table(rows).splitlines()[2].startswith("yi-6b")
    assert roofline.roofline_table(str(moved), mesh="pod2") == []

    from repro_torch.studies import roofline_bench
    monkeypatch.chdir(tmp_path)
    (line,) = roofline_bench.roofline_rows()
    name, us, derived = line.split(",")
    assert name == "roofline.yi-6b.train_4k"
    assert float(us) == pytest.approx(row.roofline_time * 1e6, abs=0.05)
    assert derived.startswith(row.dominant + "|mfu=")


# ---------------------------------------------------------------------------
# the slice as a whole: a training step's products against the reference's
# ---------------------------------------------------------------------------

#: dot-class FLOPs the port counts and the reference's compiled step does
#: not, by name, as a function of the walked record: the attention
#: backward's formula (``kernels/flops.py``) recomputes the scores,
#: 2·B·Hq·Sq·Skv·D a call, where the reference's autodiff reuses the
#: forward's (remat recomputes the forward in both)
DOT_DIFFERENCES = {
    "attention backward's score recompute": lambda ops: sum(
        e["count"] * 2 * e["in"][1][1][0] * e["in"][1][1][2]
        * e["in"][1][1][1] * e["in"][2][1][1] * e["in"][1][1][3]
        for e in ops if e["op"] == "repro_torch.flash_attention_bwd"),
}
#: what is left once the pinned differences are taken out
DOT_REL = 1e-9


class _DotsOnly(HloCostAnalyzer):
    """The reference's walk, FLOPs of its products (``dot``,
    ``convolution``, matmul custom calls) only, through fusions and
    loops."""

    def _op_cost(self, op, comp, inside_fusion):
        c = super()._op_cost(op, comp, inside_fusion)
        if op.opcode not in ("dot", "convolution", "custom-call", "fusion",
                             "while", "conditional", "call", "async-start"):
            c.flops = c.transcendentals = 0.0
        return c


def test_training_step_products_match_the_reference():
    """gemma2-9b's smoke config, one ``make_train_step`` (2 microbatches,
    remat full, AdamW) from the reference's weights carried leaf for
    leaf: the port's formula-priced FLOPs (``aten.mm`` and the attention
    kernels' custom ops) against the reference's dot FLOPs over its
    compiled step (its microbatch scan multiplied through), within
    :data:`DOT_REL` once :data:`DOT_DIFFERENCES` are taken out."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.configs.base import InputShape as JInputShape
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import (InputShape, OptimizerConfig,
                                          RunConfig)
    from repro_torch.launch import steps
    from repro_torch.models.param import carry, tree_map
    from repro_torch.optim import adamw

    arch, seq, batch_size = "gemma2-9b", 32, 4
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    okw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jrun = JRunConfig(model=jcfg, shape=JInputShape("t", seq, batch_size,
                                                    "train"),
                      optimizer=JOptimizerConfig(**okw), microbatches=2)
    run = RunConfig(model=cfg, shape=InputShape("t", seq, batch_size,
                                                "train"),
                    optimizer=OptimizerConfig(**okw), microbatches=2)
    jparams = jlm.init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq))
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}

    txt = jax.jit(jmake_train_step(jrun)).lower(
        jparams, jadamw.init_opt_state(jparams, jrun.optimizer),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    ).compile().as_text()
    want = _DotsOnly(txt).entry_cost().flops

    params = tree_map(lambda t: t.requires_grad_(),
                      carry(jax.tree.map(np.asarray, jparams), "cpu"))
    walker, rec = _walk(steps.make_train_step(run), params,
                        adamw.init_opt_state(params, run.optimizer),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    walker.track_breakdown = True
    walker.entry_cost()
    got = walker.formula_flops
    assert set(got) == {"aten.mm", "repro_torch.flash_attention",
                        "repro_torch.flash_attention_bwd"}
    ops = rec.entries()
    pinned = {k: f(ops) for k, f in DOT_DIFFERENCES.items()}
    assert all(v > 0 for v in pinned.values())
    assert sum(got.values()) - sum(pinned.values()) == pytest.approx(
        want, rel=DOT_REL)
