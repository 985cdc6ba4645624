#!/usr/bin/env python3
"""Where a training step's time goes, on one NVIDIA GPU.

    python3 tools/lm_train_trace.py [--arch A] [--num-layers N]
        [--seq-len S] [--batch B]

The port's language model at the architecture's published widths, cut
as ``chip_smoke.LM_TRAINED`` says (depth, routed experts with top-k
kept, seq, global batch: phases 16 (b), 17 (b) and 20 (b')), or to
``--num-layers``, ``--seq-len`` and ``--batch``, random bf16 weights
from seed 0, the preset's microbatches, moment dtype and remat
("full"), AdamW on the synthetic stream.  One warm-up step, one timed
on the host clock around ``torch.cuda.synchronize()``, one under
``torch.profiler``.
Every device kernel's time is put in a class: the sLSTM's forward and
backward kernels, the SSD's (the backward's own passes: the chained
scans' two, or the five passes' last three, whose recompute of the
forward's first two counts as forward),
the attention forward kernel (``flash_wg_kernel``; ``flash_mma_kernel``
on the mma.sync route) and its backward
(``bwd_wg_query_kernel`` and ``bwd_wg_key_kernel``; ``bwd_mma_kernel`` on
the fallback route), the GEMMs of ``torch.matmul``, and the rest (f32
norms, softcaps, the conv, the chunked mLSTM, the embedding gradient,
AdamW's slices, copies).  The
step's time less its kernels' sum is the device's idle time.  Prints one
JSON line, then the card's name and power limit.  Exits non-zero without
a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from lm_serve_trace import summary  # noqa: E402  (tools/ beside this file)

#: substrings of device kernel names, by class (checked in this order)
CLASSES = (
    ("slstm_backward", ("slstm_bwd_cluster_kernel",)),
    ("slstm_forward", ("slstm_cluster_kernel",)),
    ("ssd_backward", ("ssd_chain_state_kernel", "ssd_chain_grad_kernel",
                      "chunk_grad_kernel", "chunk_state_kernel<true>",
                      "state_pass_kernel<true>")),
    ("ssd_forward", ("chunk_out_kernel", "chunk_state_kernel",
                     "state_pass_kernel")),
    ("attention_backward", ("bwd_wg_query_kernel", "bwd_wg_key_kernel",
                            "bwd_mma_kernel", "bwd_kernel")),
    ("attention_forward", ("flash_wg_kernel", "flash_mma_kernel",
                           "flash_kernel")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "ampere_",
              "splitK")),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    _, _, seq, batch = chip_smoke.LM_TRAINED[args.arch]
    args.seq_len = args.seq_len if args.seq_len is not None else seq
    args.batch = args.batch if args.batch is not None else batch

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("lm_train_trace: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import InputShape
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.presets import make_run_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.param import tree_map
    from repro_torch.optim import adamw

    from repro_torch import configs
    dev = torch.device("cuda")
    cfg = chip_smoke.trained_config(configs, args.arch)
    if args.num_layers is not None:
        cfg = cfg.replace(num_layers=args.num_layers)
    run = make_run_config(args.arch, "train_4k", model_config=cfg)
    run = run.replace(shape=InputShape("trace", args.seq_len, args.batch,
                                       "train"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda p: p.requires_grad_(), lm.init(gen, cfg, dev))
    opt = adamw.init_opt_state(params, run.optimizer)
    step = make_train_step(run)
    batches = make_batch_iterator(cfg, run.shape, seed=0, device=dev)

    def one():
        nonlocal params, opt
        params, opt, metrics = step(params, opt, next(batches))
        return metrics

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    trace = summary(prof, wall_ms, 25, CLASSES)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"lm_train_trace": {
        "arch": cfg.name, "layers": cfg.num_layers,
        "experts": cfg.moe.num_experts if cfg.moe else None,
        "seq": args.seq_len,
        "batch": args.batch, "microbatches": run.microbatches,
        "remat": run.remat, "step": trace, "device": smi}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
