"""Production training launcher: ``--arch <id> --shape train_4k`` — the
counterpart of ``repro.launch.train``.

Runs on the card unless ``--device cpu``, under a (data, model) mesh of
the process group's devices (``make_host_mesh``: one device is a 1 × 1
mesh); ``--model-parallel`` must divide their count.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
      --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape, OptimizerConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import make_run_config
from repro_torch.runtime import Trainer
from repro_torch.sharding import mesh_shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_launch_train"))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = make_run_config(args.arch, args.shape, model_config=cfg)
    if args.seq_len or args.batch:
        shape = InputShape(
            "cli",
            seq_len=args.seq_len or run.shape.seq_len,
            global_batch=args.batch or run.shape.global_batch,
            kind="train")
        run = run.replace(shape=shape, microbatches=1)
    run = run.replace(
        checkpoint_dir=args.ckpt_dir,
        optimizer=OptimizerConfig(total_steps=args.steps, warmup_steps=max(
            args.steps // 10, 1)))

    mesh = make_host_mesh(model=args.model_parallel, device=args.device)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"mesh={mesh_shape(mesh)}")
    trainer = Trainer(run, mesh=mesh)
    state = trainer.restore_or_init()
    state = trainer.train(state, args.steps, log_every=10)
    trainer.save(state, blocking=True)
    print(f"done at step {state.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
