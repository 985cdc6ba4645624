"""Three-term roofline from the dry-run's records — the counterpart of
``repro.core.roofline``.

For every (arch × shape × mesh) cell the dry-run saved (i) the JSON record
with its per-device memory and FLOP count and (ii) rank 0's per-device op
program (``ops_path``, :mod:`repro_torch.core.opcost`).  This module walks
that program and derives

    compute term    = walked_FLOPs_per_device / peak_FLOP/s
    memory term     = walked_bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device   / link_bw

(The walked program is already one rank's, so the "/ chips" is built in.)
The row keeps the reference's field names: ``hlo_flops``, ``hlo_bytes``
and ``coll_wire_bytes`` hold the walked program's per-device numbers.

Hardware constants: :data:`H100_SXM`.  One link constant prices every
collective, as the reference's one ICI constant does: on the production
meshes (16 × 16, 2 × 16 × 16), which span many 8-GPU NVLink nodes, an
axis that leaves a node runs at its network card's rate instead, so the
collective term understates it there.

The overlap model of the paper (§7.4) is what justifies taking
max(compute, memory, collective) as the roofline time: it is the
calibrated p_edge → ∞ limit of the three-way overlapped cost model in
``repro_torch.core.overlap``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from repro_torch.configs import SHAPES_BY_NAME, get_config, get_smoke_config
from repro_torch.core.opcost import analyze_ops_file
from repro_torch.models.counting import model_flops

H100_SXM = dict(
    source="NVIDIA H100 SXM data sheet; the card measured here is NVIDIA "
           "H100 80GB HBM3, 700.00 W",
    peak_flops_bf16=989e12,   # dense bf16 tensor cores, per device
    hbm_bw=3.35e12,           # bytes/s per device
    link_bw=450e9,            # NVLink 4: 900 GB/s both ways, each way
    hbm_bytes=80e9,
)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities from the op walk
    hlo_flops: float
    hlo_bytes: float
    coll_wire_bytes: float
    coll_breakdown: Dict = field(default_factory=dict)
    # derived
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    model_flops_total: float = 0.0
    useful_ratio: float = 0.0      # MODEL_FLOPS / (walked FLOPs × chips)
    roofline_time: float = 0.0     # max of the three terms
    mfu_at_roofline: float = 0.0   # MODEL_FLOPS / (chips·peak·t_roofline)
    hbm_gb_per_chip: float = 0.0
    status: str = "ok"
    note: str = ""

    def finish(self, hw=H100_SXM):
        self.t_compute = self.hlo_flops / hw["peak_flops_bf16"]
        self.t_memory = self.hlo_bytes / hw["hbm_bw"]
        self.t_collective = self.coll_wire_bytes / hw["link_bw"]
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        self.roofline_time = max(terms.values())
        total_hlo = self.hlo_flops * self.chips
        self.useful_ratio = (self.model_flops_total / total_hlo
                             if total_hlo else 0.0)
        denom = self.chips * hw["peak_flops_bf16"] * self.roofline_time
        self.mfu_at_roofline = (self.model_flops_total / denom
                                if denom else 0.0)
        return self

    def as_dict(self):
        return {k: v for k, v in self.__dict__.items()}


def roofline_for_record(rec: Dict, *, hw=H100_SXM) -> RooflineRow:
    """The row of one dry-run record (a ``--smoke`` record against the
    architecture's reduced config)."""
    arch, shape_name, mesh = rec["arch"], rec["shape"], rec["mesh"]
    chips = 1
    for v in rec["mesh_shape"].values():
        chips *= v
    cfg = get_smoke_config(arch) if rec.get("smoke") else get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    row = RooflineRow(
        arch=arch, shape=shape_name, mesh=mesh, chips=chips,
        hlo_flops=0.0, hlo_bytes=0.0, coll_wire_bytes=0.0,
        model_flops_total=model_flops(cfg, shape),
    )
    if rec.get("status") != "ok":
        row.status = rec.get("status", "fail")
        row.note = rec.get("error", "")[:120]
        return row
    analysis = analyze_ops_file(rec["ops_path"], num_devices=chips)
    row.hlo_flops = analysis["flops"]
    row.hlo_bytes = analysis["bytes"]
    row.coll_wire_bytes = analysis["collective_wire_bytes"]
    row.coll_breakdown = analysis["collectives"]
    row.hbm_gb_per_chip = rec["memory"]["total_per_device_bytes"] / 2**30
    return row.finish(hw)


def roofline_table(dryrun_dir: str, *, mesh: str = "single",
                   hw=H100_SXM) -> List[RooflineRow]:
    """A row per record of ``mesh`` in ``dryrun_dir``; each record's op
    program is read from beside it (the directory may have moved)."""
    rows = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        if p.name.startswith("_") or p.name.endswith(".ops.json"):
            continue
        rec = json.loads(p.read_text())
        if rec.get("mesh") != mesh:
            continue
        if "ops_path" in rec:
            rec["ops_path"] = str(p.with_name(Path(rec["ops_path"]).name))
        try:
            rows.append(roofline_for_record(rec, hw=hw))
        except Exception as e:  # noqa: BLE001
            rows.append(RooflineRow(
                arch=rec.get("arch", "?"), shape=rec.get("shape", "?"),
                mesh=mesh, chips=0, hlo_flops=0, hlo_bytes=0,
                coll_wire_bytes=0, status="analysis-error", note=str(e)[:120]))
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':18s} {'shape':12s} {'t_comp(s)':>10s} {'t_mem(s)':>10s} "
           f"{'t_coll(s)':>10s} {'bound':>6s} {'useful':>7s} {'MFU@roof':>8s} "
           f"{'HBM(GiB)':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.status != "ok":
            lines.append(f"{r.arch:18s} {r.shape:12s} {r.status}: {r.note}")
            continue
        lines.append(
            f"{r.arch:18s} {r.shape:12s} {r.t_compute:10.3e} "
            f"{r.t_memory:10.3e} {r.t_collective:10.3e} "
            f"{r.dominant[:6]:>6s} {r.useful_ratio:7.3f} "
            f"{r.mfu_at_roofline:8.3f} {r.hbm_gb_per_chip:8.2f}")
    return "\n".join(lines)
