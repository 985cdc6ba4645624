"""The port's mesh (``repro_torch.launch.mesh``, DTensor) on the CPU.

* ``apply_moe_a2a`` on a gloo (2, 4) mesh in 8 processes — the
  counterpart of ``tests/test_moe.py::test_a2a_dispatch_matches_scatter``
  (8 fake XLA devices there): deepseek-v2-236b's smoke config at the
  drop-free capacity 8.0, parameters carried from the reference's numpy
  tree; its output within 1e-4 × max |y| of the reference's
  ``apply_moe``, its input gradient within 1e-4 × max |g| of the port's
  scatter path, nothing dropped.
* Each model-layer kernel's sharding on a gloo 2 × 2 mesh in 4
  processes: its wrapper (``kernels.ops``, run on local blocks) on
  DTensors laid out several ways against the same wrapper on the whole
  tensors (``tests/test_kernels.py:17``'s tolerance), forward and
  backward.
* ``Trainer`` on a 1 × 1 gloo mesh against the reference's
  ``Trainer(mesh=make_mesh((1, 1)))`` from the reference's initial
  weights, losses within 1e-5 — the counterpart of
  ``tests/test_substrate.py::test_elastic_reshard_preserves_state``.
* The dry-run (``launch.dryrun``) on the production fake meshes for one
  train, one prefill and one decode cell of smoke configs, each in its
  own process under 30 s; the sweep (``launch.dryrun_all``) skipping a
  cell whose record is ok; ``examples/elastic_restart_torch.py``.

Multi-process runs go through a script in ``tmp_path`` on a
``FileStore`` there (no TCP port: the suite runs in several workers).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import moe_schema as jmoe_schema
from repro.models.param import init_tree as jinit_tree
from repro.runtime import Trainer as JTrainer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (SHAPES_BY_NAME, InputShape,
                                     OptimizerConfig, RunConfig)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.param import carry, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer
from repro_torch.runtime.trainer import TrainState

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_kernels.py:17, float32

SCRIPT = '''
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, store, inp, outp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", {shape!r}, mesh_dim_names={names!r})
    data = dict(np.load(inp))
    out = {{}}
{body}
    if rank == 0:
        np.savez(outp, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(work, args=({world}, {store!r}, {inp!r}, {outp!r}),
             nprocs={world})
'''


def run_ranks(tmp_path: Path, shape, names, body: str, inputs: dict,
              timeout: int = 600) -> dict:
    """``body`` (statements; ``rank``, ``mesh``, ``data`` and ``out`` in
    scope) in one process per rank of a gloo ``shape`` mesh named
    ``names``; rank 0's ``out`` arrays."""
    world = int(np.prod(shape))
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **inputs)
    script = tmp_path / "ranks.py"
    script.write_text(SCRIPT.format(
        src=str(ROOT / "src"), shape=tuple(shape), names=tuple(names),
        body=textwrap.indent(textwrap.dedent(body), "    "), world=world,
        store=str(tmp_path / "store"), inp=str(inp), outp=str(outp)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(outp))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------------
# apply_moe_a2a at 8 ranks
# ---------------------------------------------------------------------------

A2A_BODY = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.models.moe import apply_moe, moe_schema
from repro_torch.models.moe_a2a import apply_moe_a2a
from repro_torch.models.param import axes_tree, carry
from repro_torch.sharding import use_mesh

cfg = get_smoke_config("deepseek-v2-236b")
cfg = cfg.replace(moe=cfg.moe.replace(capacity_factor=8.0))
tree = {}
for key, arr in data.items():
    if key.startswith("p/"):
        node = tree
        *path, leaf = key[2:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
x, dy = torch.from_numpy(data["x"]), torch.from_numpy(data["dy"])
params = carry(tree, "cpu", axes=axes_tree(moe_schema(cfg)), mesh=mesh)
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()
with use_mesh(mesh), implicit_replication():
    y, aux = apply_moe_a2a(params, cfg, xd)
    dyd = distribute_tensor(dy, mesh, list(y.placements))
    (gx,) = torch.autograd.grad((y * dyd).sum(), [xd])
out["y"] = y.full_tensor().detach().numpy()
out["gx"] = gx.full_tensor().numpy()
out["frac_dropped"] = aux["moe_frac_dropped"].full_tensor().numpy()
xs = x.clone().requires_grad_()
ys, _ = apply_moe(carry(tree, "cpu"), cfg, xs)
(gs,) = torch.autograd.grad((ys * dy).sum(), [xs])
out["gx_scatter"] = gs.numpy()
"""


def test_a2a_dispatch_matches_scatter_at_8_ranks(tmp_path):
    cfg = jget_smoke("deepseek-v2-236b")
    cfg = cfg.replace(moe=cfg.moe.replace(capacity_factor=8.0))
    p = jinit_tree(jax.random.PRNGKey(0), jmoe_schema(cfg), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    y_ref, _ = japply_moe(p, cfg, x)
    y_ref = np.asarray(y_ref)
    dy = np.random.default_rng(2).standard_normal(y_ref.shape).astype(
        np.float32)
    got = run_ranks(tmp_path, (2, 4), ("data", "model"), A2A_BODY, {
        **{f"p/{k}": v for k, v in _flat(p).items()},
        "x": np.asarray(x), "dy": dy})
    rel = np.abs(got["y"] - y_ref).max() / np.abs(y_ref).max()
    assert rel < 1e-4, rel
    g = got["gx_scatter"]
    assert np.abs(got["gx"] - g).max() <= 1e-4 * np.abs(g).max()
    assert float(got["frac_dropped"]) == 0.0


# ---------------------------------------------------------------------------
# The custom ops' sharding strategies at 4 ranks
# ---------------------------------------------------------------------------

OPS_BODY = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import ops

t = {k: torch.from_numpy(v) for k, v in data.items()}
R, S0 = Replicate(), Shard(0)


def ok(got, want):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return bool(np.allclose(got.detach().numpy(), want.detach().numpy(),
                            rtol=2e-4, atol=2e-5))


def flat(out):
    if not isinstance(out, tuple):
        return (out,)
    return out[:1] + (out[1] if isinstance(out[1], tuple) else out[1:])


def run(fn, args, layout=None, dy=None):
    # fn's results (and with dy, the gradients of <y, dy>) on the whole
    # tensors, or on DTensors laid out as layout
    if layout is not None:
        args = [distribute_tensor(a, mesh, layout[i])
                for i, a in enumerate(args)]
    leaves = [a.detach().requires_grad_(dy is not None) for a in args]
    out = flat(fn(*leaves))
    if dy is None:
        return out
    if layout is not None:
        dy = distribute_tensor(dy, mesh, list(out[0].placements))
    return out[:1] + torch.autograd.grad((out[0] * dy).sum(), leaves)


def check(name, fn, args, layouts, dy=None):
    want = run(fn, args, dy=dy)
    out[name] = np.array([all(ok(g, w) for g, w in zip(
        run(fn, args, layout, dy), want)) for layout in layouts])


def check_layout(name, fn, args, layout, dy, placements):
    # the results keep the layout's shards: no rank gathers the operands
    want = run(fn, args, dy=dy)
    got = run(fn, args, layout, dy)
    out[name] = np.array([all(ok(g, w) for g, w in zip(got, want)),
                          tuple(got[0].placements) == placements])


q, k, v, do = t["q"], t["k"], t["v"], t["do"]


def attention(*a):
    return ops.flash_attention(*a, causal=True, softcap=20.0, scale=0.25,
                               block_q=32, block_k=32)


heads = [S0, Shard(2)]
batch4, seq4 = [[S0, R]] * 4, [[R, Shard(1)]] * 4
check("flash_attention", attention, (q, k, v),
      [[heads] * 3, batch4, seq4, [[Shard(2), R], [S0, R], [S0, R]]])
check("flash_attention_bwd", attention, (q, k, v),
      [[heads] * 3, batch4, seq4], dy=do)
x, da, bm, cm, dy = t["x"], t["da"], t["bm"], t["cm"], t["dy"]


def ssd(*a):
    return ops.mamba2_ssd(*a, chunk=16)


def ssd_state(*a):
    return ops.mamba2_ssd_state(*a, chunk=16)


check("mamba2_ssd", ssd, (x, da, bm, cm), [[heads] * 4, batch4, seq4])
check("mamba2_ssd_state", ssd_state, (x, da, bm, cm), [[heads] * 4, batch4])
check("mamba2_ssd_bwd", ssd, (x, da, bm, cm), [[heads] * 4, batch4, seq4],
      dy=dy)
g, r, b, dh = t["g"], t["r"], t["b"], t["dh"]
heads3 = [[S0, Shard(3)], [R, Shard(0)], [R, Shard(1)]]
batch = [[S0, R], [R, R], [R, R]]
hidden = [[S0, R], [R, Shard(3)], [R, Shard(2)]]   # xlstm_opt's layout
for name in ("slstm_cell", "slstm_cell_state"):
    check(name, getattr(ops, name), (g, r, b), [heads3, batch, hidden])
# under autograd the forward keeps its trajectory (the traj op)
check("slstm_cell_traj", lambda *a: ops.slstm_cell(
    *(u.requires_grad_() for u in a)), (g, r, b), [heads3, batch, hidden])
check("slstm_cell_bwd", ops.slstm_cell, (g, r, b), [heads3, batch, hidden],
      dy=dh)
check_layout("wrapper_flash_attention", attention, (q, k, v), [heads] * 3,
             do, (S0, Shard(2)))
check_layout("wrapper_mamba2_ssd", ssd, (x, da, bm, cm), batch4, dy,
             (S0, R))
check_layout("wrapper_slstm_cell", ops.slstm_cell, (g, r, b), heads3, dh,
             (S0, Shard(2)))
"""

OP_NAMES = ("flash_attention", "flash_attention_bwd", "mamba2_ssd",
            "mamba2_ssd_state", "mamba2_ssd_bwd", "slstm_cell",
            "slstm_cell_state", "slstm_cell_traj", "slstm_cell_bwd",
            "wrapper_flash_attention", "wrapper_mamba2_ssd",
            "wrapper_slstm_cell")


@pytest.fixture(scope="module")
def strategies(tmp_path_factory):
    rng = np.random.default_rng(7)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    B, S, Hq, Hkv, D = 4, 32, 4, 2, 16
    return run_ranks(tmp_path_factory.mktemp("strategies"), (2, 2),
                     ("data", "model"), OPS_BODY, {
        "q": rn(B, S, Hq, D), "k": rn(B, S, Hkv, D), "v": rn(B, S, Hkv, D),
        "do": rn(B, S, Hq, D),
        "x": rn(4, 32, 4, 8), "da": -np.abs(rn(4, 32, 4, scale=0.1)),
        "bm": rn(4, 32, 4, 6), "cm": rn(4, 32, 4, 6), "dy": rn(4, 32, 4, 8),
        "g": rn(4, 6, 4, 4, 8, scale=0.5), "r": rn(4, 8, 4, 8, scale=0.1),
        "b": rn(4, 4, 8, scale=0.1), "dh": rn(4, 6, 4, 8)})


@pytest.mark.parametrize("name", OP_NAMES)
def test_custom_op_strategy_matches_the_plain_op(strategies, name):
    """The kernels' wrappers on DTensors: every layout of the operands
    (sharded on batch, on heads, on a dimension no way shards — which
    redistributes to replicated) gives the op's results, and its
    gradients (the backward ops on the local blocks), on the whole
    tensors; the ``wrapper_`` cases keep the layout's shards."""
    assert strategies[name].all(), strategies[name]


# ---------------------------------------------------------------------------
# Trainer under a 1 × 1 mesh against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_trainer_on_a_mesh_matches_the_reference(tmp_path, host_mesh):
    """The reference trains under ``make_mesh((1, 1))``; the port under a
    1 × 1 gloo mesh from the reference's initial weights (parameters and
    moments DTensors): every loss within 1e-5, and the mesh-less port
    from the same weights gives the same losses bit for bit."""
    shape = ("tiny", 32, 8, "train")
    opt = dict(learning_rate=1e-3, warmup_steps=5, total_steps=100)
    jrun = JRunConfig(model=jget_smoke("yi-6b"), shape=JInputShape(*shape),
                      optimizer=JOptimizerConfig(**opt), microbatches=2,
                      checkpoint_every=0,
                      checkpoint_dir=str(tmp_path / "jckpt"))
    jtr = JTrainer(jrun, mesh=jmake_mesh((1, 1), ("data", "model")))
    jstate = jtr.init_state(0)
    w0 = jax.tree.map(np.asarray, jstate.params)
    jtr.train(jstate, 3, log_every=0)
    want = [m["loss"] for m in jtr.metrics_log if "loss" in m]

    cfg = get_smoke_config("yi-6b")

    def port(mesh, name):
        run = RunConfig(model=cfg, shape=InputShape(*shape),
                        optimizer=OptimizerConfig(**opt), microbatches=2,
                        checkpoint_every=0, checkpoint_dir=str(tmp_path / name))
        tr = Trainer(run, mesh=mesh, device="cpu")
        params = tree_map(lambda t: t.requires_grad_(), carry(
            w0, "cpu", axes=lm.param_axes(cfg), mesh=mesh))
        state = TrainState(params, adamw.init_opt_state(params, run.optimizer))
        tr.train(state, 3, log_every=0)
        return [m["loss"] for m in tr.metrics_log if "loss" in m]

    meshed = port(host_mesh, "mesh")
    np.testing.assert_allclose(meshed, want, rtol=1e-5)
    assert port(None, "plain") == meshed


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------


def _dryrun(out: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={**__import__("os").environ, "PYTHONPATH": str(
            ROOT / "src")})


@pytest.mark.parametrize("arch,shape,mesh", [
    ("yi-6b", "train_4k", "single"),
    ("gemma2-9b", "prefill_32k", "pod2"),
    ("xlstm-125m", "decode_32k", "pod2")])
def test_dryrun_cell_on_the_production_fake_mesh(tmp_path, arch, shape,
                                                 mesh):
    proc = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--mesh",
                   mesh, "--smoke")
    rec = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                     .read_text())
    assert proc.returncode == 0 and rec["status"] == "ok", \
        rec.get("traceback", proc.stderr[-3000:])
    assert rec["mesh_shape"] == ({"data": 16, "model": 16} if mesh ==
                                 "single" else
                                 {"pod": 2, "data": 16, "model": 16})
    assert rec["total_s"] < 30 and rec["overrides"] == {}
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["total_per_device_bytes"] == mem["argument_bytes"] + \
        mem["temp_bytes"]
    cost = rec["cost"]
    assert cost["flops"] == sum(cost["flops_by_op"].values()) > 0
    assert cost["flops_per_device"] == cost["flops"] / (
        256 if mesh == "single" else 512)


def test_dryrun_counts_the_kernels_at_their_global_shapes(tmp_path):
    """The attention kernel's FLOPs in a prefill cell's record are its
    formula (``kernels/flops.py``: 2·B·Hq·Sq·Skv·(D + Dv) a call) at the
    global shapes, once a layer — not at a rank's local blocks, where the
    kernels run under the mesh."""
    arch, shape = "gemma2-9b", "prefill_32k"
    proc = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--mesh",
                   "pod2", "--smoke")
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod2.json").read_text())
    assert proc.returncode == 0 and rec["status"] == "ok", \
        rec.get("traceback", proc.stderr[-3000:])
    cfg, sh = get_smoke_config(arch), SHAPES_BY_NAME[shape]
    a = cfg.attention
    want = cfg.num_layers * 2 * sh.global_batch * a.num_heads * \
        sh.seq_len ** 2 * 2 * a.head_dim
    assert rec["cost"]["flops_by_op"]["repro_torch.flash_attention"] == want


def test_dryrun_sweep_skips_cells_already_ok(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun_all", "--out",
           str(tmp_path), "--only", "whisper-tiny", "--meshes", "single",
           "--smoke"]
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           cwd=ROOT, env=env)
    assert first.returncode == 0, first.stderr[-3000:]
    summary = json.loads((tmp_path / "_summary.json").read_text())
    assert len(summary) == 3 and all(v.startswith("ok") for v in
                                     summary.values()), summary
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                           cwd=ROOT, env=env)
    summary = json.loads((tmp_path / "_summary.json").read_text())
    assert all(v == "ok (cached)" for v in summary.values()), summary
    assert "3/3 cells ok" in again.stdout


def test_elastic_restart_example_runs(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "elastic_restart_torch.py"),
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "auto-restores: 1" in proc.stdout
    assert "resharded onto mesh {'data': 1, 'model': 1} at step 12" in \
        proc.stdout
    assert "phase 2 done at step 20" in proc.stdout
