"""Hold the port's dry-run against the reference's compiled dry-run, cell
by cell.

For each (arch, shape, mesh) the architecture's config is cut to
``--layers`` at full width (zamba2-7b to its 3 prefix layers and one
group of 6, the smallest depth whose groups are whole) and run twice,
each in a fresh process:

* the reference: ``repro.launch.dryrun.run_cell`` (jit, lower, compile on
  512 host devices), its HLO walked by ``repro.core.hlo``;
* the port: ``repro_torch.launch.dryrun.run_cell`` (the step traced on
  the fake mesh), its per-device op program walked by
  ``repro_torch.core.opcost``.

One JSON row a cell: both statuses (and errors), per-device walked FLOPs,
per-device product FLOPs by class, memory (``temp_bytes``: temporaries),
collective wire bytes in all and by kind, and the ratio port ÷
reference of each (``ratio.wire_by_kind``: each kind's).  Each side also
lists its collectives by signature — kind, group size, operand and
result dtypes and shapes, on the port's side the mesh axis its group
spans (``axis``), and on the reference's side its ``replica_groups``,
``dimensions`` and the tail of its ``op_name`` — with
their summed wire bytes and count: the five largest by wire as
``collectives``, all of them as ``all_collectives``.  The port's come
from its ``.ops.json`` record (a gather along dimension d > 0 shows as
DTensor's stack along dimension 0), the reference's from its HLO text.
Each side lists its largest temporaries as ``peak_buffers``: the port's
from its dry-run record (the largest live storages near its peak), the
reference's with ``--buffers`` (the largest values of the temporaries'
allocation in the buffer assignment XLA dumps, one an offset).
Product classes are read by shape on both sides (as
``opcost.product_flops`` reads a width):

* ``head`` — products with a dimension of the (padded) vocabulary, whole
  or split over the model axis;
* ``mlp`` — products without batch dimensions that have a dimension of
  an MLP's or an expert's hidden width (whole or split over the model
  axis), and batched products that neither contract over a mixer's
  head width nor yield it (the experts');
* ``projections`` — the other products without batch dimensions that
  have a dimension of the model width or of MLA's low ranks: q, k, v
  and o, MLA's and the frontends';
* ``attention`` — the sequence mixers: the port's kernel custom ops
  (attention, SSD, sLSTM: their formulas), batched products over a
  mixer's head width (score and value products, the mLSTM's and MLA's,
  decode's einsums), and the products left (the reference's score and
  value products where one rank holds one row and one head, which XLA
  writes without batch dimensions).

A width can name two classes (internvl2-2b's d_ff ÷ 16 is the
reference's query chunk, 512); the classes are a diagnosis, the totals
the comparison.

Usage:
  PYTHONPATH=src python tools/dryrun_parity.py --arch gemma2-9b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python tools/dryrun_parity.py --all --jobs 2 \\
      --out runs/parity > runs/parity/rows.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ("attention", "projections", "mlp", "head")
#: HLO ops whose cost is their computations' (priced inside them)
CONTAINERS = ("fusion", "while", "conditional", "call", "async-start")
#: the collectives each side of a row lists first, the largest by wire
TOP = 5


def cut_layers(arch: str, layers: int) -> tuple:
    """(layers, note): zamba2-7b's depth must be its prefix and whole
    groups of its shared-attention period."""
    if arch == "zamba2-7b":
        return 9, "zamba2-7b cut to 3 prefix layers + one group of 6"
    return layers, ""


# ---------------------------------------------------------------------------
# classification by shape (shared by both sides)
# ---------------------------------------------------------------------------


def widths(cfg, model: int = 16) -> dict:
    """The widths that name a product's class: each MLP's and expert's
    hidden width and the padded vocabulary, whole and over the model
    axis; the model width; MLA's low ranks; the mixers' head widths."""
    from repro_torch.models.lm import padded_vocab
    ff = {cfg.d_ff} if cfg.d_ff else set()
    if cfg.moe is not None:
        m = cfg.moe
        ff |= {m.d_ff_expert, m.d_ff_shared * m.num_shared_experts,
               m.dense_residual_d_ff}
    ff.discard(0)
    split = lambda ws: {w for x in ws for w in (x, x // model)  # noqa: E731
                        if x % model == 0} | set(ws)
    a = cfg.attention
    lora = {a.kv_lora_rank, a.q_lora_rank} - {0}
    heads = {a.head_dim, a.qk_nope_head_dim, a.v_head_dim,
             a.qk_nope_head_dim + a.qk_rope_head_dim, a.qk_rope_head_dim,
             *lora}
    if cfg.ssm is not None:
        heads |= {cfg.ssm.head_dim, cfg.ssm.d_state}
    if cfg.xlstm is not None:
        x = cfg.xlstm
        heads |= {int(x.m_proj_factor * cfg.d_model) // x.num_heads,
                  cfg.d_model // x.num_heads}
    return {"mlp": split(ff), "head": split({padded_vocab(cfg)}),
            "d_model": cfg.d_model, "lora": lora, "heads": heads - {0}}


def classify(m: int, k: int, n: int, batched: bool, w: dict) -> str:
    """The class of a product [.., m, k] × [.., k, n] (``batched``: with
    batch dimensions)."""
    dims = (m, k, n)
    if any(d in w["head"] for d in dims):
        return "head"
    if not batched:
        if any(d in w["mlp"] for d in dims):
            return "mlp"
        if w["d_model"] in dims or any(d in w["lora"] for d in dims):
            return "projections"
        return "attention"
    return "attention" if k in w["heads"] or n in w["heads"] else "mlp"


# ---------------------------------------------------------------------------
# one side, in its own process
# ---------------------------------------------------------------------------


#: the reference's side, a program of its own run with ``python -c``
#: (argv: arch, shape, mesh, layers, out); it prints its row as the last
#: line.  This module imports neither jax nor the reference, so that
#: only the child process that compiles the reference's cell does.
REFERENCE_PROGRAM = r"""
import dataclasses, json, math, re, sys
from pathlib import Path
import repro.launch.dryrun as dr
from repro.configs import get_config
from repro.core import hlo
import dryrun_parity as tool

arch, shape, mesh, layers, out, buffers = sys.argv[1:]
layers, out = int(layers), Path(out)
cfg = dataclasses.replace(get_config(arch), num_layers=layers)
make = dr.make_run_config
dr.make_run_config = lambda a, s, overrides=None: make(
    a, s, overrides=overrides, model_config=cfg)
dump = out / f"xla_dump_{arch}__{shape}__{mesh}"
if buffers == "1":   # read at the backend's start, after the import's flags
    import os
    os.environ["XLA_FLAGS"] += f" --xla_dump_to={dump}"
rec = dr.run_cell(arch, shape, mesh, out)
row = {"status": rec["status"], "seconds": rec["total_s"]}
if rec["status"] != "ok":
    row["error"] = rec["error"][:600]
    print(json.dumps(row))
    sys.exit(0)
n_dev = math.prod(rec["mesh_shape"].values())
w = tool.widths(tool.port_config(arch, layers))
dot_re = re.compile(r"(\w+)_contracting_dims=\{([\d,]*)\}")
groups_re = re.compile(r"replica_groups=(\S+),\s")
dims_re = re.compile(r"dimensions=\{([\d,]*)\}")
name_re = re.compile(r'op_name="([^"]*)"')


def dims(side, rest):
    m = re.search(side + r"_batch_dims=\{([\d,]*)\}", rest)
    return [int(i) for i in m.group(1).split(",") if i] if m else []


class Walker(hlo.HloCostAnalyzer):
    # the reference's walk, each op's FLOPs also by opcode, each dot's by
    # class and each collective's wire by its signature (carried as
    # zero-wire collective entries, so loops multiply them)

    def _op_cost(self, op, comp, inside_fusion):
        c = super()._op_cost(op, comp, inside_fusion)
        kind = op.opcode[:-6] if op.opcode.endswith("-start") else op.opcode
        if kind in hlo.COLLECTIVES and not op.opcode.endswith("-done"):
            key = "coll:" + json.dumps(tool.signature(
                kind, hlo._group_size(op, n_dev),
                [s for ss in hlo._operand_shapes(op, comp) for s in ss],
                op.result, groups=groups_re.search(op.rest),
                dimensions=dims_re.search(op.rest),
                op_name=name_re.search(op.rest)))
            c.coll_payload[key] = c.coll_wire[kind]
            c.coll_wire[key], c.coll_count[key] = 0.0, 1.0
            return c
        if op.opcode == "fusion":   # the walk keeps a fusion's FLOPs only
            m = hlo._CALLS_RE.search(op.rest)
            if m and m.group(1) in self.comps:
                inner = self.comp_cost(m.group(1), inside_fusion=True)
                for key, v in inner.coll_payload.items():
                    if key.startswith(("dot:", "op:")):
                        c.coll_payload[key] = v
                        c.coll_wire[key] = c.coll_count[key] = 0.0
            return c
        if op.opcode in tool.CONTAINERS:
            return c
        if c.flops:
            key = "op:" + op.opcode
            c.coll_payload[key] = c.flops
            c.coll_wire[key] = c.coll_count[key] = 0.0
        if op.opcode != "dot":
            return c
        (_, lhs), (_, rhs) = [s[0] for s in
                              hlo._operand_shapes(op, comp)[:2]]
        con = dict((side, [int(i) for i in d.split(",") if i])
                   for side, d in dot_re.findall(op.rest))
        lb, rb = dims("lhs", op.rest), dims("rhs", op.rest)
        kk = math.prod([lhs[i] for i in con.get("lhs", [])])
        mm = math.prod([d for i, d in enumerate(lhs)
                        if i not in con.get("lhs", []) and i not in lb])
        nn = math.prod([d for i, d in enumerate(rhs)
                        if i not in con.get("rhs", []) and i not in rb])
        key = "dot:" + tool.classify(mm, kk, nn, bool(lb), w)
        c.coll_payload[key] = c.flops
        c.coll_wire[key] = c.coll_count[key] = 0.0
        return c


path = rec["hlo_path"]
data = open(path, "rb").read()
if path.endswith(".zst"):
    import zstandard as zstd
    data = zstd.ZstdDecompressor().decompress(data, max_output_size=1 << 31)
cost = Walker(data.decode(), num_devices=n_dev).entry_cost()
row.update(tool.summary(cost.flops, cost.coll_wire, cost.coll_payload))
row["flops_by_op"] = dict((k[3:], v) for k, v in cost.coll_payload.items()
                          if k.startswith("op:"))
row.update(tool.collective_lists(
    {**json.loads(k[5:]), "wire": v, "count": cost.coll_count[k]}
    for k, v in cost.coll_payload.items() if k.startswith("coll:")))
row["memory"] = rec["memory"]
if buffers == "1":
    import shutil
    row["peak_buffers"] = tool.temp_values(dump)
    shutil.rmtree(dump, ignore_errors=True)
print(json.dumps(row))
"""

#: a buffer assignment's value line: id, name, size, offset, shape
_VALUE_RE = re.compile(r" value: <\d+ (\S+) @\d+> \(size=(\d+),"
                       r"offset=(\d+)\): (.*)")


def temp_values(dump: Path, top: int = 12) -> list:
    """The reference's largest buffers: the values of the temporaries'
    allocation (``preallocated-temp``) in the buffer assignment XLA dumped
    under ``dump`` (the module with the largest such allocation), one a
    distinct offset (the largest of those sharing it over time), largest
    first."""
    best, best_size = [], -1
    for f in Path(dump).glob("*buffer-assignment.txt"):
        values, size, inside = {}, 0, False
        for line in f.read_text().splitlines():
            if line.startswith("allocation "):
                inside = "preallocated-temp" in line
                if inside:
                    size = int(line.split("size ")[1].split(",")[0])
                continue
            m = _VALUE_RE.match(line) if inside else None
            if m:
                name, nbytes, offset, shape = m.groups()
                have = values.get(offset)
                if have is None or int(nbytes) > have["bytes"]:
                    values[offset] = {"bytes": int(nbytes), "op": name,
                                      "shape": shape.split("{")[0]}
        if size > best_size:
            best_size = size
            best = sorted(values.values(), key=lambda v: -v["bytes"])
    return best[:top]


#: the reference's sweep, (arch, shape) pairs in its order, as JSON
REFERENCE_CELLS = r"""
import json
from repro.configs import get_config, shapes_for
from repro.launch.dryrun_all import ORDER
print(json.dumps([[a, s.name] for a in ORDER for s in shapes_for(get_config(a))]))
"""


def port_config(arch: str, layers: int):
    """The port's config of ``arch`` cut to ``layers`` at full width (the
    reference's copy has the same fields and values)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def port_side(arch, shape, mesh, layers, out: Path) -> dict:
    from repro_torch.core.opcost import (OpCostAnalyzer, PRODUCTS,
                                         collective_kind, parse_ops)
    from repro_torch.launch import dryrun

    cfg = port_config(arch, layers)
    rec = dryrun.run_cell(arch, shape, mesh, out, model_config=cfg)
    row = {"status": rec["status"], "seconds": rec["total_s"]}
    if rec["status"] != "ok":
        row["error"] = rec["error"][:600]
        return row
    n_dev = math.prod(rec["mesh_shape"].values())
    ops = parse_ops(Path(rec["ops_path"]).read_text())
    walker = OpCostAnalyzer(ops, num_devices=n_dev, track_breakdown=True)
    cost = walker.entry_cost()
    w = widths(cfg)
    by_class = {}
    for e in ops:
        name = e["op"]
        if name.startswith("repro_torch."):   # the kernels' formulas
            cls = "attention"
        elif name in PRODUCTS:
            a, b = [s for _, s in e["in"][-2:]]
            cls = classify(a[-2], a[-1], b[-1], len(a) > 2, w)
        else:
            continue
        key = "dot:" + cls
        by_class[key] = by_class.get(key, 0.0) + (e.get("flops") or 0.0)
    row.update(summary(cost.flops, cost.coll_wire, by_class))
    row["flops_by_op"] = {k: v for k, v in walker.flop_breakdown.items()
                          if v}
    row.update(collective_lists(
        {**signature(kind, e.get("group") or n_dev, e["in"], e["out"],
                     axis=e.get("axis")),
         "wire": walker.op_cost(e).coll_wire[kind] * e["count"],
         "count": e["count"]}
        for e in ops for kind in [collective_kind(e["op"])] if kind))
    row["ops_path"] = rec["ops_path"]
    row["memory"] = rec["memory"]
    row["peak_buffers"] = rec.get("peak_buffers", [])
    return row


def summary(flops, wire, payload) -> dict:
    """A side's FLOPs, product FLOPs by class and wire bytes by
    collective kind (the keys without a ``prefix:``)."""
    products = {c: float(payload.get("dot:" + c, 0.0)) for c in CLASSES}
    by_kind = {k: float(v) for k, v in wire.items() if ":" not in k and v}
    return {
        "walked_flops": float(flops),
        "products": products,
        "product_flops": sum(products.values()),
        "wire_bytes": sum(by_kind.values()),
        "wire_by_kind": by_kind,
    }


def signature(kind, group, ins, outs, *, groups=None, dimensions=None,
              op_name=None, axis=None) -> dict:
    """A collective as the rows list it: kind, group size, operand and
    result (dtype, shape) pairs; the port's also the mesh ``axis`` its
    group spans; the reference's its ``replica_groups``, ``dimensions``
    and the tail of its ``op_name`` (regex matches, or None)."""
    sig = {"kind": kind, "group": int(group),
           "in": [[dt, list(d)] for dt, d in ins],
           "out": [[dt, list(d)] for dt, d in outs]}
    if axis:
        sig["axis"] = axis
    if groups:
        sig["replica_groups"] = groups.group(1)[:80]
    if dimensions:
        sig["dimensions"] = dimensions.group(1)
    if op_name:
        sig["op_name"] = "/".join(op_name.group(1).split("/")[-3:])
    return sig


def collective_lists(items) -> dict:
    """A side's collectives, those of one signature summed (wire bytes,
    count): ``all_collectives``, every signature by wire, largest first;
    ``collectives``, the first :data:`TOP` of them."""
    out = {}
    for it in items:
        key = json.dumps({k: v for k, v in it.items()
                          if k not in ("wire", "count")}, sort_keys=True)
        have = out.setdefault(key, {**it, "wire": 0.0, "count": 0.0})
        have["wire"] += float(it["wire"])
        have["count"] += float(it["count"])
    ranked = sorted(out.values(), key=lambda c: -c["wire"])
    return {"collectives": ranked[:TOP], "all_collectives": ranked}


# ---------------------------------------------------------------------------
# the parent: both sides a cell, rows
# ---------------------------------------------------------------------------


def _side(side, arch, shape, mesh, layers, out: Path, timeout,
          buffers=False) -> dict:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        (str(ROOT / "src"), str(Path(__file__).resolve().parent))),
        "JAX_PLATFORMS": "cpu"}
    if side == "reference":
        cmd = [sys.executable, "-c", REFERENCE_PROGRAM, arch, shape, mesh,
               str(layers), str(out / side), str(int(buffers))]
    else:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--side",
               side, "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--layers", str(layers), "--out", str(out / side)]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "seconds": round(time.time() - t0, 1)}
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        return {"status": "fail", "seconds": round(time.time() - t0, 1),
                "error": proc.stderr[-600:]}
    return json.loads(lines[-1])


def _ratio(p, r):
    return p / r if r else (None if p else 1.0)


def parity_row(arch, shape, mesh, layers, out: Path, timeout=1800,
               buffers=False) -> dict:
    n, note = cut_layers(arch, layers)
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(
            lambda s: _side(s, arch, shape, mesh, n, out, timeout, buffers),
            ("reference", "port"))
    row = {"arch": arch, "shape": shape, "mesh": mesh, "layers": n,
           "reference": ref, "port": port}
    if note:
        row["note"] = note
    if ref["status"] == port["status"] == "ok":
        row["ratio"] = {
            "walked_flops": _ratio(port["walked_flops"],
                                   ref["walked_flops"]),
            "product_flops": _ratio(port["product_flops"],
                                    ref["product_flops"]),
            **{c: _ratio(port["products"][c], ref["products"][c])
               for c in CLASSES},
            "wire_bytes": _ratio(port["wire_bytes"], ref["wire_bytes"]),
            "temp_bytes": _ratio(port["memory"]["temp_bytes"],
                                 ref["memory"]["temp_bytes"]),
            "wire_by_kind": {
                k: _ratio(port["wire_by_kind"].get(k, 0.0),
                          ref["wire_by_kind"].get(k, 0.0))
                for k in sorted({*port["wire_by_kind"],
                                 *ref["wire_by_kind"]})},
        }
    return row


def all_cells(meshes):
    """The reference's sweep (its ``dryrun_all.ORDER`` × ``shapes_for``)
    × ``meshes``, read from the reference in a child process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE_CELLS],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          check=True)
    for arch, shape in json.loads(proc.stdout.splitlines()[-1]):
        for mesh in meshes:
            yield arch, shape, mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--all", action="store_true",
                    help="the reference's sweep: ORDER × shapes × meshes")
    ap.add_argument("--meshes", default="single,pod2")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once (each runs two processes)")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--out", default="runs/parity")
    ap.add_argument("--buffers", action="store_true",
                    help="the reference's largest temporaries too, from "
                         "XLA's dumped buffer assignment (slower)")
    ap.add_argument("--side", choices=("port",), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.side:
        print(json.dumps(port_side(args.arch, args.shape, args.mesh,
                                   args.layers, out)))
        return 0
    if args.all:
        cells = list(all_cells(args.meshes.split(",")))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.mesh)]
    out.mkdir(parents=True, exist_ok=True)
    bad = 0
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        for row in pool.map(lambda c: parity_row(
                *c, args.layers, out, args.timeout, args.buffers), cells):
            print(json.dumps(row), flush=True)
            bad += row["reference"]["status"] == "ok" and \
                row["port"]["status"] != "ok"
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
