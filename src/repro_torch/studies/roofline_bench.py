"""Roofline bench: re-derives the three-term roofline for every
(arch × shape) cell from the saved dry-run records — the counterpart of
the reference's ``benchmarks/roofline_bench.py``.

Rows: ``roofline.<arch>.<shape>,<roofline_time_us>,<dominant-term>`` plus
per-cell MFU-at-roofline.  Reads ``runs/dryrun_torch`` under the working
directory (written by ``python -m repro_torch.launch.dryrun_all``); emits
a note row if it is not there.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

DRYRUN_DIR = Path("runs/dryrun_torch")


def roofline_rows() -> List[str]:
    if not DRYRUN_DIR.exists():
        return ["roofline.skipped_no_dryrun_artifacts,0,"]
    from repro_torch.core.roofline import roofline_table

    rows = []
    for r in roofline_table(str(DRYRUN_DIR), mesh="single"):
        if r.status != "ok":
            rows.append(f"roofline.{r.arch}.{r.shape},0,{r.status}")
            continue
        rows.append(
            f"roofline.{r.arch}.{r.shape},{r.roofline_time * 1e6:.1f},"
            f"{r.dominant}|mfu={r.mfu_at_roofline:.4f}"
            f"|useful={r.useful_ratio:.3f}")
    return rows
