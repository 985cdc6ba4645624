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
from typing import Dict, Optional

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape, ModelConfig, OptimizerConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import make_run_config
from repro_torch.launch.serve import BLOCK_LAUNCHES, KERNELS
from repro_torch.models.blocks import effective_pattern, effective_prefix
from repro_torch.runtime import Trainer
from repro_torch.sharding import mesh_shape


def _call_dtypes(cfg: ModelConfig, block: str, encoder: bool) -> Dict:
    """{kernel: [operand dtype of each call]} one pass through ``block``
    makes: attention in the activation dtype — but an encoder's layers
    over the frames, and the cross-attention that meets their output, in
    f32 (the frames are f32 as the data pipeline draws them, and
    ``blockwise_attention`` promotes a mix to f32); the SSD and the sLSTM
    always in f32."""
    act = cfg.activation_dtype
    out = {}
    for name, n in BLOCK_LAUNCHES[block].items():
        if name != "flash_attention":
            out[name] = ["float32"] * n
        elif encoder:
            out[name] = ["float32"] * n
        elif block == "xattn_layer":          # self-, then cross-attention
            out[name] = [act, "float32"]
        else:
            out[name] = [act] * n
    return out


def step_launches(cfg: ModelConfig, microbatches: int, remat: str = "full",
                  dtype: Optional[str] = None) -> Dict[str, int]:
    """The hand kernels' launches one train step at ``cfg`` makes on the
    card, forward (by launch counter, as ``launch.serve.KERNELS``) and
    backward (``<kernel>_bwd``); with ``dtype``, only the calls whose
    operands are of that dtype.  Under remat ``full`` or ``dots`` each
    body group's kernels run twice forward (the forward and its
    recompute) and once backward; the prefix blocks and an
    encoder-decoder's encoder layers run outside remat, once each way;
    zamba2's shared block runs once a group, inside it.  All of it once
    a microbatch."""
    twice = 2 if remat in ("full", "dots") else 1
    passes = [(b, 1, False) for b in effective_prefix(cfg)]
    group = list(effective_pattern(cfg))
    if cfg.shared_attn_every:
        group.append("attn_mlp")
    passes += [(b, twice, False) for b in group] * cfg.num_groups
    if cfg.encdec is not None:
        passes += [("bidir_attn_mlp", 1, True)] \
            * cfg.encdec.num_encoder_layers
    out = {k: 0 for name in KERNELS for k in (name, f"{name}_bwd")}
    for block, forward, encoder in passes:
        for name, dts in _call_dtypes(cfg, block, encoder).items():
            n = sum(dtype is None or dt == dtype for dt in dts)
            out[name] += n * forward * microbatches
            out[f"{name}_bwd"] += n * microbatches
    return out


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
