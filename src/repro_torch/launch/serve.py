"""Serving launcher: batched prefill + greedy decode for ``--arch`` under
a (data, model) mesh of the process group's devices — the counterpart of
``repro.launch.serve``.  One device is a 1 × 1 mesh (``make_host_mesh``;
``--model-parallel`` must divide the device count): as in the
reference, the model runs under ``use_mesh`` with unsharded weights, so
its activation constraints (``shard_act``) see local tensors.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
      --smoke --batch 4 --prompt-len 16 --tokens 32 --device cpu

Weights and prompt are random, drawn from seed 0 on the device.  One
warm-up request (prefill and two decode steps on its own cache) runs
first; then the prefill and each decode step are timed between CUDA
events (host clock on the CPU).  On the card, attention in prefill runs
``flash_attention``, the Mamba-2 scan ``mamba2_ssd`` and the sLSTM
``slstm_cell``; decode runs none of them.  The last line of output is a
JSON object ``{"serve": {...}}`` with the times, tokens per second, the
device's peak memory (of the init, and of the timed request) and the
hand kernels' launches in prefill and in decode (a prefill's are
:func:`prefill_launches`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, mamba2_ssd, slstm_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.blocks import effective_pattern, effective_prefix
from repro_torch.models.param import param_count, tree_leaves
from repro_torch.sharding import mesh_shape, use_mesh

#: the hand kernels a served model may launch, by launch counter
KERNELS = {"flash_attention": flash_attention, "mamba2_ssd": mamba2_ssd,
           "slstm_cell": slstm_cell}


#: the hand-kernel launches of one prefill through a block, by block id
BLOCK_LAUNCHES = {
    "attn_mlp": {"flash_attention": 1},
    "local_attn_mlp": {"flash_attention": 1},
    "bidir_attn_mlp": {"flash_attention": 1},
    "moe_layer": {"flash_attention": 1},
    "xattn_layer": {"flash_attention": 2},     # self- and cross-attention
    "mamba2": {"mamba2_ssd": 1},
    "slstm": {"slstm_cell": 1},
    "mlstm": {},                               # the plain chunked form
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def front_positions(cfg) -> int:
    """Positions a decoder-only model's frontend prepends to the prompt
    (internvl2's patch embeddings); whisper's frames go to its encoder."""
    return cfg.frontend.num_positions \
        if cfg.frontend.kind != "none" and cfg.encdec is None else 0


def prefill_launches(cfg) -> Dict[str, int]:
    """The hand kernels' launches one prefill at ``cfg`` makes on the
    card: each block's (:data:`BLOCK_LAUNCHES`) over the prefix and every
    group of the body, zamba2's shared attention once a group, and an
    encoder-decoder's encoder layers."""
    out = dict.fromkeys(KERNELS, 0)
    blocks = list(effective_prefix(cfg)) \
        + list(effective_pattern(cfg)) * cfg.num_groups
    if cfg.shared_attn_every:
        blocks += ["attn_mlp"] * cfg.num_groups
    if cfg.encdec is not None:
        blocks += ["bidir_attn_mlp"] * cfg.encdec.num_encoder_layers
    for block in blocks:
        for name, n in BLOCK_LAUNCHES[block].items():
            out[name] += n
    return out


class _Clock:
    """Elapsed milliseconds between two marks: CUDA events on the card,
    the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, start, end) -> float:
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3


def make_request(cfg, batch: int, prompt_len: int, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    req = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=gen, device=device)}
    if cfg.frontend.kind != "none":
        req["frontend"] = torch.randn(
            (batch, cfg.frontend.num_positions, cfg.frontend.d_frontend),
            generator=gen, device=device)
    return req


def generate(params, cfg, request: Dict[str, torch.Tensor], tokens: int,
             clock: Optional[_Clock] = None):
    """Prefill ``request`` into a fresh cache, then ``tokens - 1`` greedy
    decode steps.  Returns the generated tokens [B, tokens] and stats:
    whether every logit was finite, the launches in each phase and, with
    a clock, the prefill's ms and each decode step's ms."""
    prompt = request["tokens"]
    B, P = prompt.shape
    dev = prompt.device
    n_front = front_positions(cfg)
    cache = lm.zero_cache(cfg, B, P + n_front + tokens, dev)
    stats = {}
    before = launch_counts()
    t0 = clock.mark() if clock else None
    cache, logits = lm.prefill(params, cfg, cache, request)
    tok = logits.argmax(-1)
    if clock:
        t1 = clock.mark()
        stats["prefill_ms"] = clock.ms(t0, t1)
    finite = torch.isfinite(logits).all()
    mid = launch_counts()
    out, step_ms = [tok], []
    for i in range(tokens - 1):
        t0 = clock.mark() if clock else None
        cache, logits = lm.decode_step(params, cfg, cache, tok,
                                       P + n_front + i)
        tok = logits.argmax(-1)
        if clock:
            step_ms.append(clock.ms(t0, clock.mark()))
        finite &= torch.isfinite(logits).all()
        out.append(tok)
    after = launch_counts()
    stats["finite"] = bool(finite)
    stats["decode_step_ms"] = step_ms
    stats["launches"] = {
        "prefill": {k: mid[k] - before[k] for k in before},
        "decode": {k: after[k] - mid[k] for k in before}}
    return torch.cat(out, dim=1), stats


def serve(cfg, *, batch: int, prompt_len: int, tokens: int, device
          ) -> Dict:
    """Serve one random request at ``cfg`` on ``device`` (after one
    warm-up request); returns the measurements."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = lm.init(gen, cfg, dev)
        request = make_request(cfg, batch, prompt_len, gen, dev)
        if cuda:
            torch.cuda.synchronize(dev)
            init_peak = torch.cuda.max_memory_allocated(dev)
        init_s = time.perf_counter() - t0
        clock = _Clock(dev)
        generate(params, cfg, request, min(tokens, 3))
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        out, stats = generate(params, cfg, request, tokens, clock)
    steps = stats["decode_step_ms"]
    decode_ms = sum(steps) / len(steps) if steps else float("nan")
    res = {
        "arch": cfg.name, "device": str(dev), "batch": batch,
        "prompt_len": prompt_len, "tokens": tokens,
        "params": param_count(params),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(params)),
        "init_s": init_s,
        "prefill_ms": stats["prefill_ms"],
        "decode_ms_per_token": decode_ms,
        "prefill_tokens_per_s": batch * prompt_len / stats["prefill_ms"] * 1e3,
        "decode_tokens_per_s": batch / decode_ms * 1e3 if steps else None,
        "launches": stats["launches"],
        "logits_finite": stats["finite"],
        "generated": out.tolist(),
    }
    if cuda:
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        res["init_max_memory_allocated"] = init_peak
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the model's depth (full width kept)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = make_host_mesh(model=args.model_parallel, device=args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.num_layers is not None:
        cfg = cfg.replace(num_layers=args.num_layers)
    print(f"mesh={mesh_shape(mesh)}")
    with use_mesh(mesh):
        res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    tokens=args.tokens, device=args.device)
    print(f"prefill: {res['prefill_ms']:.1f} ms")
    print(f"decode: {res['decode_ms_per_token']:.2f} ms/token × batch "
          f"{args.batch}")
    res.pop("generated")
    print(json.dumps({"serve": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
