"""End-to-end training entry point: a dense LM with the full runtime — data
pipeline, AdamW, activation remat, async checkpointing, fault-tolerant
restart, straggler monitoring — the counterpart of the reference's
``examples/train_lm.py``, with its two presets and flags, plus
``--device`` (the card unless ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.train_lm --preset small \\
      --steps 300 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m \\
      --steps 200
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (
    AttentionConfig,
    InputShape,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
)
from repro_torch.runtime import Trainer

PRESETS = {
    # ~10M params
    "small": ModelConfig(
        name="lm-small", family="dense", num_layers=4, d_model=256,
        d_ff=1024, vocab_size=8192,
        attention=AttentionConfig(num_heads=8, num_kv_heads=4, head_dim=32),
        param_dtype="float32", activation_dtype="float32",
    ),
    # ~100M params (the deliverable-scale config; same code path)
    "100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=10, d_model=640,
        d_ff=2560, vocab_size=32000,
        attention=AttentionConfig(num_heads=10, num_kv_heads=5, head_dim=64),
        param_dtype="float32", activation_dtype="float32",
    ),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="use an assigned arch's smoke config instead")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_train_lm"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.arch else PRESETS[args.preset]
    run = RunConfig(
        model=cfg,
        shape=InputShape("cli", seq_len=args.seq_len,
                         global_batch=args.batch, kind="train"),
        optimizer=OptimizerConfig(
            learning_rate=args.lr, warmup_steps=20, total_steps=args.steps),
        microbatches=1,
        remat="full",
        checkpoint_every=50,
        checkpoint_dir=args.ckpt_dir,
    )
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")
    trainer = Trainer(run, device=args.device)
    state = trainer.restore_or_init()
    if state.step:
        print(f"resuming from checkpoint at step {state.step}")
    state = trainer.train(state, args.steps, log_every=10)
    trainer.save(state, blocking=True)
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    if trainer.monitor.events:
        print(f"stragglers flagged: {len(trainer.monitor.events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
