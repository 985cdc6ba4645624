"""The port's dry-run held against the reference's compiled dry-run, cell
by cell (``tools/dryrun_parity.py``): each case compiles the reference's
cell (``repro.launch.dryrun.run_cell``, its HLO walked by
``repro.core.hlo``) and traces the port's (``repro_torch.launch.dryrun``,
its op program walked by ``repro_torch.core.opcost``), each in a fresh
process, at full width cut to 2 layers.

* Per device, the port's walked FLOPs and product FLOPs are within
  :data:`BAND` of the reference's, once each pricing difference named in
  :data:`PRICING` is taken out of both sides.
* Where the query heads split over the model axis and the key/value
  heads do not (gemma2-9b: 16 / 8, yi-6b: 32 / 4 under 16), the
  attention kernel and the key/value projections run on each rank's
  share of the query heads, as the reference's program does.
* The split leaves the mesh-less path as it was: a smoke config's loss
  and gradients are the same with and without a 1 × 1 mesh.
"""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "dryrun_parity", ROOT / "tools" / "dryrun_parity.py")
parity = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(parity)

#: port ÷ reference, per device, walked FLOPs and product FLOPs
BAND = (0.9, 1.15)
LAYERS = 2

#: FLOPs each side's walk prices differently for the same work, by name:
#: (the reference's, the port's) as functions of a side's row, taken out
#: of the walked FLOPs before the band.  The reference's CPU compile
#: widens bf16 to f32 around its scanned caches and states and writes a
#: cache update as a select over the whole cache, in fusions its walker
#: prices element by element; the port casts each operand once
#: (``aten._to_copy``) and writes a slot in place (``index_put_``,
#: priced at nothing).
PRICING = {
    "dtype conversions and whole-cache selects": (
        lambda side: side["flops_by_op"].get("convert", 0.0)
        + side["flops_by_op"].get("select", 0.0),
        lambda side: side["flops_by_op"].get("aten._to_copy", 0.0)
        + side["flops_by_op"].get("aten.where", 0.0)),
}


def _row(tmp_path, arch, shape, mesh="single"):
    row = parity.parity_row(arch, shape, mesh, LAYERS, tmp_path,
                            timeout=600)
    for side in ("reference", "port"):
        assert row[side]["status"] == "ok", row[side].get("error")
    return row


def _record(row) -> dict:
    return json.loads(Path(row["port"]["ops_path"]).with_suffix("")
                      .with_suffix(".json").read_text())


def _walked_ratio(row) -> float:
    ref, port = row["reference"], row["port"]
    r = ref["walked_flops"] - sum(f(ref) for f, _ in PRICING.values())
    p = port["walked_flops"] - sum(g(port) for _, g in PRICING.values())
    return p / r


def _in_band(row):
    lo, hi = BAND
    assert lo <= _walked_ratio(row) <= hi, row["ratio"]
    assert lo <= row["ratio"]["product_flops"] <= hi, row["ratio"]


def _product_flops(ops, width):
    from repro_torch.core.opcost import product_flops
    return product_flops(ops, width)


@pytest.mark.parametrize("arch,shape", [("gemma2-9b", "train_4k"),
                                        ("yi-6b", "prefill_32k")])
def test_attention_and_kv_projections_split_on_the_query_heads(
        tmp_path, arch, shape):
    """On the 16 × 16 mesh, per device: the attention kernel's walked
    FLOPs are the record's (the same custom ops at the global shapes) ÷
    256 — every rank its batch block and its query heads; the q, k, v
    and o projections' product FLOPs are the even split (train: the
    key/value heads repeated up to the query heads', each rank one
    repeat beside its query head; prefill: each rank every key/value
    head at its 16th of the positions, as the cache holds them), equal
    to the reference's, and none runs at a width the mesh should have
    split; walked and product FLOPs within :data:`BAND`."""
    from repro_torch.configs import get_config
    from repro_torch.core.opcost import parse_ops
    from repro_torch.launch.presets import make_run_config
    row = _row(tmp_path, arch, shape)
    rec = _record(row)
    ops = parse_ops(Path(row["port"]["ops_path"]).read_text())
    chips = 256
    kernels = [op for op in ("repro_torch.flash_attention",
                             "repro_torch.flash_attention_bwd")
               if op in rec["cost"]["flops_by_op"]]
    walked = sum(e["flops"] for e in ops if e["op"] in kernels)
    assert walked * chips == sum(rec["cost"]["flops_by_op"][op]
                                 for op in kernels) > 0
    cfg = dataclasses.replace(get_config(arch), num_layers=LAYERS)
    run = make_run_config(arch, shape, model_config=cfg)
    a, d = cfg.attention, cfg.d_model
    tokens = run.shape.global_batch * run.shape.seq_len
    q_width, kv_width = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    per = 2 * tokens * d * LAYERS / chips     # a product, each width unit
    if run.shape.kind == "train":   # remat full: four products a weight
        assert _product_flops(ops, q_width // 16) == \
            4 * 4 * per * q_width
        assert _product_flops(ops, kv_width) == 0
    else:
        assert _product_flops(ops, q_width // 16) == 2 * per * q_width
        assert _product_flops(ops, kv_width) == 2 * per * kv_width
    if q_width != d:    # yi-6b's 32 · 128 is its model width
        assert _product_flops(ops, q_width) == 0
    assert row["port"]["products"]["projections"] == \
        row["reference"]["products"]["projections"]
    _in_band(row)


def test_decode_cell_traces_and_prices_as_the_reference(tmp_path):
    """yi-6b ``decode_32k`` on 16 × 16: it traces in the port (the
    decode attention's GQA reshapes of query heads sharded over the
    model axis go through ``sharding.reshape``) and its product FLOPs
    equal the reference's — the key/value projections contracting over
    d_model split on the model axis (their FSDP blocks moved there, as
    XLA moves them) — and its walked FLOPs are within :data:`BAND` once
    :data:`PRICING` is taken out."""
    row = _row(tmp_path, "yi-6b", "decode_32k")
    assert row["port"]["product_flops"] == \
        pytest.approx(row["reference"]["product_flops"], rel=1e-9)
    _in_band(row)


def test_pod2_cell_within_the_band(tmp_path):
    """granite-8b ``train_4k`` on 2 × 16 × 16 (32 / 8 heads): walked and
    product FLOPs within :data:`BAND`, the projections equal to the
    reference's."""
    row = _row(tmp_path, "granite-8b", "train_4k", "pod2")
    assert row["port"]["products"]["projections"] == \
        row["reference"]["products"]["projections"]
    _in_band(row)


def test_pricing_differences_are_the_named_ops(tmp_path):
    """gemma2-9b ``decode_32k`` on 2 × 16 × 16: the products are the
    reference's to the FLOP, yet the walked FLOPs fall outside
    :data:`BAND` (the reference's walk prices its CPU compile's f32
    widening of the bf16 caches and its select-written cache update,
    element by element, each layer); taking :data:`PRICING`'s ops out of
    both walks, and nothing else, brings them inside it."""
    row = _row(tmp_path, "gemma2-9b", "decode_32k", "pod2")
    ref, port = row["reference"], row["port"]
    assert port["product_flops"] == pytest.approx(ref["product_flops"],
                                                  rel=1e-9)
    assert not BAND[0] <= row["ratio"]["walked_flops"] <= BAND[1]
    (ref_ops, port_ops), = PRICING.values()
    assert ref_ops(ref) > 0.3 * ref["walked_flops"]
    assert port_ops(port) < 0.02 * port["walked_flops"]
    _in_band(row)


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_the_mesh_less_path_is_unchanged(host_mesh):
    """gemma2-9b's smoke config (4 / 2 heads): one training step's loss
    and every parameter's gradient under a 1 × 1 gloo mesh (parameters
    DTensors) equal the mesh-less step's bit for bit: nothing the mesh's
    layout adds (the key/value repeats, the blocked weight gradients)
    acts where every axis has one rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.param import place, tree_map
    from repro_torch.sharding import use_mesh
    cfg = get_smoke_config("gemma2-9b")
    params = lm.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}

    def step(p):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = lm.lm_loss(p, cfg, batch)
        return loss, torch.autograd.grad(loss, _leaves(p))

    loss, grads = step(params)
    with use_mesh(host_mesh), implicit_replication():
        placed = place(params, lm.param_axes(cfg), host_mesh)
        mloss, mgrads = step(placed)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    assert torch.equal(full(mloss).detach(), loss.detach())
    assert all(torch.equal(full(g), h) for g, h in zip(mgrads, grads))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
