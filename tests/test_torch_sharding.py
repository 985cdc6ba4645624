"""The port's logical-axis sharding (``repro_torch.sharding``) against the
reference's (``repro.sharding``) on the CPU.

The reference's 8 tests of ``tests/test_sharding.py``, ported onto a
1 × 1 (and 1 × 1 × 1) gloo ``DeviceMesh`` of this process alone (a
``HashStore``, no TCP port: the suite runs in several workers); then,
for each of the ten architectures on ``FakeMesh`` shapes 16 × 16 and
2 × 16 × 16 under all four rule presets, every parameter leaf's spec and
every cache leaf's spec of each shape the architecture has equal the
reference's, as tuples; and each cell's per-device argument bytes
(``launch.specs.per_device_bytes``) equal the sum of the reference's
local shard sizes — arithmetic, nothing compiled.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import get_config as jget_config
from repro.configs import shapes_for as jshapes_for
from repro.launch import specs as JS
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.sharding import axes as jaxes
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adamw
from repro_torch.sharding import (PartitionSpec as P, logical_to_placements,
                                  logical_to_pspec,
                                  shard_act, tree_shardings, use_mesh)
from repro_torch.sharding.axes import RULE_PRESETS


@pytest.fixture
def one_rank():
    """A gloo process group of this process alone, taken down after."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture
def mesh(one_rank):
    return make_mesh((1, 1), ("data", "model"), device="cpu")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# tests/test_sharding.py
# ---------------------------------------------------------------------------


def test_basic_resolution(mesh):
    spec = logical_to_pspec(("embed", "ff"), mesh)
    assert spec == P("data", "model")


def test_virtual_dp_axis(mesh):
    spec = logical_to_pspec(("batch", "seq"), mesh)
    assert spec == P("data")


def test_multi_pod_virtual_axes(one_rank):
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    spec = logical_to_pspec(("batch", None, "ff"), mesh)
    assert spec == P(("pod", "data"), None, "model")


def test_divisibility_guard_abstract():
    from repro_torch.sharding.axes import _axis_size

    fake = FakeMesh({"data": 16, "model": 16})
    assert _axis_size(fake, ("data", "model")) == 256
    spec = logical_to_pspec(("batch", "kv_seq", "kv_heads", "head_dim"),
                            fake, dim_sizes=(128, 32768, 8, 128))
    assert spec == P("data", "model")


def test_no_axis_reuse():
    # both dims want "model": only the first gets it
    spec = logical_to_pspec(("vocab", "ff"), FakeMesh(MESHES["single"]),
                            dim_sizes=(512, 512))
    assert spec == P("model")


def test_shard_act_noop_without_mesh():
    x = torch.ones((4, 4))
    y = shard_act(x, "batch", None)
    assert torch.equal(x, y)


def test_shard_act_with_mesh(mesh):
    with use_mesh(mesh):
        x = distribute_tensor(torch.ones((4, 4)), mesh,
                              [Replicate(), Replicate()])
        y = shard_act(x, "batch", "act_ff")
        assert torch.equal(x.full_tensor(), y.full_tensor())
        with pytest.raises(ValueError, match="rank-2"):
            shard_act(x, "batch")


def test_tree_shardings_structure(mesh):
    axes = {"w": ("embed", "ff"), "b": ("ff",)}
    specs = {"w": torch.empty((8, 8), device="meta"),
             "b": torch.empty((8,), device="meta")}
    sh = tree_shardings(axes, specs, mesh=mesh)
    assert sh["w"].spec == P("data", "model")
    assert sh["b"].spec == P("model")


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def test_placements_follow_mesh_order():
    """A dimension spread over ("pod", "data") takes Shard(d) on both
    mesh dimensions, in mesh order; an unnamed mesh axis replicates."""
    fake = FakeMesh(MESHES["pod2"])
    assert logical_to_placements(("batch", None, "ff"), fake) == [
        Shard(0), Shard(0), Shard(2)]
    assert logical_to_placements(("embed", "head_dim"), fake,
                                 dim_sizes=(64, 8)) == [
        Shard(0), Shard(0), Replicate()]


def test_placements_replicate_on_a_size_one_axis(mesh):
    assert logical_to_placements(("embed", "ff"), mesh) == [
        Replicate(), Replicate()]


# ---------------------------------------------------------------------------
# Every architecture's specs against the reference's
# ---------------------------------------------------------------------------


def _spec_pairs(port_axes, port_abs, ref_axes, ref_abs):
    """(port leaf axes, shape, reference leaf axes, shape) in one order."""
    ref_leaves = jax.tree.leaves(ref_axes, is_leaf=lambda x:
                                 isinstance(x, tuple))
    ref_shapes = [tuple(s.shape) for s in jax.tree.leaves(ref_abs)]
    port_leaves = _sorted_leaves(port_axes)
    port_shapes = [tuple(t.shape) for t in _sorted_leaves(port_abs)]
    assert len(port_leaves) == len(ref_leaves) == len(ref_shapes)
    return list(zip(port_leaves, port_shapes, ref_leaves, ref_shapes))


def _sorted_leaves(tree):
    """The leaves of a nested dict in jax's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_spec_matches_the_reference(arch, mesh_kind):
    fake = FakeMesh(MESHES[mesh_kind])
    cfg, jcfg = get_config(arch), jget_config(arch)
    trees = [(lm.param_axes(cfg), lm.abstract_params(cfg),
              jlm.param_axes(jcfg), jlm.abstract_params(jcfg))]
    for shape in jshapes_for(jcfg):
        B, L = shape.global_batch, shape.seq_len
        trees.append((lm.cache_axes(cfg, B, L), lm.abstract_cache(cfg, B, L),
                      jlm.cache_axes(jcfg, B, L),
                      jlm.abstract_cache(jcfg, B, L)))
    checked = 0
    for preset, rules in RULE_PRESETS.items():
        jrules = jaxes.RULE_PRESETS[preset]
        for tree in trees:
            for axes, shape, jaxes_, jshape in _spec_pairs(*tree):
                assert tuple(axes) == tuple(jaxes_) and shape == jshape
                got = logical_to_pspec(axes, fake, rules, dim_sizes=shape)
                want = jaxes.logical_to_pspec(jaxes_, fake, jrules,
                                              dim_sizes=jshape)
                assert tuple(got) == tuple(want), (preset, axes, shape)
                checked += 1
    assert checked > 0


def _ref_local_bytes(axes_tree, abs_tree, mesh, itemsize=None):
    """Σ over the reference's leaves of its local shard's size × its
    itemsize (``itemsize`` overrides it)."""
    sizes = mesh.shape
    total = 0
    pairs = zip(jax.tree.leaves(axes_tree,
                                is_leaf=lambda x: isinstance(x, tuple)),
                jax.tree.leaves(abs_tree))
    for axes, sds in pairs:
        spec = jaxes.logical_to_pspec(axes, mesh, dim_sizes=sds.shape)
        n = 1
        for d, dim in enumerate(sds.shape):
            entry = spec[d] if d < len(spec) else None
            names = (entry,) if isinstance(entry, str) else entry or ()
            n *= dim // math.prod(sizes[a] for a in names)
        total += n * (itemsize or jnp.dtype(sds.dtype).itemsize)
    return total


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_argument_bytes_match_the_reference(arch, mesh_kind):
    """Per device, each (shape × mesh) cell's arguments as the dry-run
    builds them: parameters, optimizer moments (the count replicated)
    and batch for train; parameters, cache and batch for prefill;
    parameters, cache and tokens for decode.  The port's token arrays
    are int64 (torch's index dtype) where the reference's are int32, so
    those leaves count 8 bytes an element on both sides."""
    from repro.launch.presets import make_run_config as jmake_run_config
    from repro_torch.launch.presets import make_run_config
    fake = FakeMesh(MESHES[mesh_kind])
    cfg, jcfg = get_config(arch), jget_config(arch)
    for jshape in jshapes_for(jcfg):
        shape = SHAPES_BY_NAME[jshape.name]
        run = make_run_config(arch, shape.name)
        jrun = jmake_run_config(arch, jshape.name)
        with use_mesh(fake), jaxes.use_mesh(fake):
            params = lm.abstract_params(cfg)
            sh = S.shardings_for(lm.param_axes(cfg), params, fake)
            got = S.per_device_bytes(sh, params)
            want = _ref_local_bytes(jlm.param_axes(jcfg),
                                    jlm.abstract_params(jcfg), fake)
            B, L = shape.global_batch, shape.seq_len
            if shape.kind == "train":
                opt = adamw.abstract_opt_state(params, run.optimizer)
                got += S.per_device_bytes(
                    adamw.opt_state_axes(sh)._replace(count=None), opt)
                jopt = jadamw.abstract_opt_state(jlm.abstract_params(jcfg),
                                                 jrun.optimizer)
                jaxes_opt = jadamw.opt_state_axes(jlm.param_axes(jcfg))
                want += _ref_local_bytes(jaxes_opt.mu, jopt.mu, fake)
                want += _ref_local_bytes(jaxes_opt.nu, jopt.nu, fake)
                want += 4   # the count, int32 in both
                batch = S.train_batch_specs(cfg, shape)
                jbatch = JS.train_batch_specs(jcfg, jshape)
            else:
                cache = lm.abstract_cache(cfg, B, L)
                got += S.per_device_bytes(S.shardings_for(
                    lm.cache_axes(cfg, B, L), cache, fake), cache)
                want += _ref_local_bytes(jlm.cache_axes(jcfg, B, L),
                                         jlm.abstract_cache(jcfg, B, L),
                                         fake)
                batch = (S.prefill_specs(cfg, shape) if shape.kind ==
                         "prefill" else
                         {"tokens": S.decode_specs(cfg, shape)["tokens"]})
                jbatch = (JS.prefill_specs(jcfg, jshape) if jshape.kind ==
                          "prefill" else
                          {"tokens": JS.decode_specs(jcfg, jshape)["tokens"]})
            axes = {k: v for k, v in S.batch_axes(cfg).items() if k in batch}
            got += S.per_device_bytes(S.shardings_for(axes, batch, fake),
                                      batch)
            for k in jbatch:
                want += _ref_local_bytes(
                    {k: JS.batch_axes(jcfg)[k]}, {k: jbatch[k]}, fake,
                    itemsize=8 if k in ("tokens", "targets") else None)
        assert got == want, (arch, shape.name, got, want)


def test_rule_presets_match_the_reference():
    assert set(RULE_PRESETS) == set(jaxes.RULE_PRESETS)
    for name, rules in RULE_PRESETS.items():
        assert rules == jaxes.RULE_PRESETS[name]


def test_specs_are_meta_never_allocations():
    cfg = get_config("gemma2-9b")
    shape = SHAPES_BY_NAME["train_4k"]
    for t in S.train_batch_specs(cfg, shape).values():
        assert t.device.type == "meta"
    for t in tree_leaves(lm.abstract_cache(cfg, 2, 64)):
        assert t.device.type == "meta"
    assert S.text_len(cfg, shape) == JS.text_len(jget_config("gemma2-9b"),
                                                 shape)
    np.testing.assert_equal(S.local_shape((64, 32), P("data"),
                                          FakeMesh(MESHES["single"])),
                            (4, 32))


RESHAPE_SCRIPT = '''
import logging, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=6)
mesh = init_device_mesh("cpu", (2, 3), mesh_dim_names=("data", "model"))
from repro_torch.sharding import reshape
x = DTensor.from_local(torch.zeros(2, 4, 2, 2), mesh, [Shard(0), Shard(2)],
                       run_check=False, shape=(4, 4, 5, 2),
                       stride=(40, 10, 2, 1))
for _ in range(2):
    y = reshape(x, (4, 4, 10))
print("shape", tuple(y.shape), [str(p) for p in y.placements])
'''


def test_reshape_gathers_only_what_dtensor_refuses_and_says_so(tmp_path):
    """A reshape that DTensor cannot carry (dim 2, 5 wide, sharded
    3-way) is logged once and done after gathering that dimension, the
    batch shard kept; any other error passes through."""
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.sharding.local import _is_propagation_error
    script = tmp_path / "reshape.py"
    script.write_text(RESHAPE_SCRIPT)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "shape (4, 4, 10) ['S(0)', 'R']" in proc.stdout
    assert proc.stdout.count("DTensor cannot carry") == 1, proc.stdout
    assert not _is_propagation_error(torch.OutOfMemoryError("out of memory"))
    assert not _is_propagation_error(RuntimeError("shape mismatch"))
    assert _is_propagation_error(RuntimeError(
        "Sharding propagation failed for aten.view.default(...)"))
