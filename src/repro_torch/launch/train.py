"""Production training launcher: ``--arch <id> --shape train_4k`` — the
counterpart of ``repro.launch.train``.

Runs on the card unless ``--device cpu``.  ``--model-parallel`` above 1
(a mesh) waits for ROADMAP queue A item 5.

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
from repro_torch.launch.presets import make_run_config
from repro_torch.runtime import Trainer


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
    if args.model_parallel != 1:
        print("--model-parallel: training over a mesh is ROADMAP queue A "
              "item 5", file=sys.stderr)
        return 2

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

    # one device: the reference's 1 × 1 host mesh
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"mesh={{'data': 1, 'model': 1}}")
    trainer = Trainer(run, device=args.device)
    state = trainer.restore_or_init()
    state = trainer.train(state, args.steps, log_every=10)
    trainer.save(state, blocking=True)
    print(f"done at step {state.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
