"""Sweep driver: run the dry-run for every (arch × shape × mesh) cell —
the counterpart of ``repro.launch.dryrun_all``.

Each cell runs in a fresh subprocess (the fake process group is one a
process) and is idempotent — cells with an existing ``status: ok``
record are skipped, so the sweep can be re-launched after fixes.
``--jobs N`` runs N cells at once.  The sweep exits 1 when a cell ends
other than ``ok``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs import get_config, shapes_for
from repro_torch.launch.dryrun import DEFAULT_OUT

# smallest-first so failures surface early
ORDER = [
    "whisper-tiny", "xlstm-125m", "internvl2-2b", "yi-6b", "granite-8b",
    "gemma2-9b", "zamba2-7b", "nemotron-4-15b", "arctic-480b",
    "deepseek-v2-236b",
]


def cells(meshes):
    for arch in ORDER:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            for mesh in meshes:
                yield arch, shape.name, mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--meshes", default="single,pod2")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--only", default=None, help="comma-separated arch filter")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="each architecture's reduced config (tests)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in its own process")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = args.meshes.split(",")
    only = set(args.only.split(",")) if args.only else None

    def run(cell):
        arch, shape, mesh = cell
        key = f"{arch}__{shape}__{mesh}"
        rec_path = out / f"{key}.json"
        if rec_path.exists() and not args.force:
            try:
                rec = json.loads(rec_path.read_text())
                if rec.get("status") == "ok":
                    return key, "ok (cached)"
            except json.JSONDecodeError:
                pass
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(out)] + (["--smoke"] if args.smoke else [])
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            status = "ok" if proc.returncode == 0 else "fail"
            if status == "fail":
                (out / f"{key}.stderr").write_text(proc.stderr[-8000:])
        except subprocess.TimeoutExpired:
            status = "timeout"
        result = f"{status} ({time.time() - t0:.0f}s)"
        print(f"[sweep] {key}: {result}", flush=True)
        return key, result

    todo = [c for c in cells(meshes) if not only or c[0] in only]
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results = dict(pool.map(run, todo))

    n_ok = sum(1 for v in results.values() if v.startswith("ok"))
    print(f"\n[sweep] {n_ok}/{len(results)} cells ok")
    (out / "_summary.json").write_text(json.dumps(results, indent=2))
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
