"""Elastic scaling + fault tolerance demo on the PyTorch/CUDA port.

Train without a mesh, checkpoint, inject a failure (auto-restore), then
reshard the live state onto a (data, model) mesh and keep training — the
single-process realization of losing/gaining pod slices.  Runs on the
card (a 1 × 1 mesh on a one-rank NCCL group) unless ``--device cpu``
(gloo).

  PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import (InputShape, OptimizerConfig,  # noqa: E402
                                      RunConfig)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402
from repro_torch.sharding import mesh_shape  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_elastic_demo"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg = get_smoke_config("yi-6b")
    run = RunConfig(
        model=cfg,
        shape=InputShape("demo", seq_len=32, global_batch=8, kind="train"),
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=5,
                                  total_steps=100),
        microbatches=2, checkpoint_every=5, checkpoint_dir=args.ckpt_dir,
        max_step_retries=2,
    )

    # phase 1: train with an injected failure at step 8
    fails = {8: True}
    tr = Trainer(run, mesh=None, failure_hook=lambda s: fails.pop(s, False),
                 device=args.device)
    state = tr.train(tr.restore_or_init(), 12, log_every=5)
    restored = [m for m in tr.metrics_log if m.get("event") == "restored"]
    print(f"phase 1 done at step {state.step}; "
          f"auto-restores: {len(restored)}")

    # phase 2: elastic reshard onto an explicit (data, model) mesh
    mesh = make_mesh((1, 1), ("data", "model"), device=args.device)
    state = tr.reshard(state, mesh)
    print(f"resharded onto mesh {mesh_shape(mesh)} at step {state.step}")
    state = tr.train(state, 20, log_every=5)
    tr.ckpt.wait()
    losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
    print(f"phase 2 done at step {state.step}; "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
