"""Analytic parameter / FLOP accounting, derived from the same schemas the
model is built from — the counterpart of ``repro.models.counting``.

Counts come from the schema alone: nothing is allocated or traced, so a
full configuration (``arctic-480b``'s 480 B parameters) is counted, never
built.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.param import ParamSpec


def _leaves_with_path(tree, prefix=()) -> Iterator[Tuple[tuple, ParamSpec]]:
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, prefix + (k,))


def config_param_count(cfg: ModelConfig) -> int:
    from repro_torch.models.lm import model_schema

    return sum(int(np.prod(s.shape))
               for _, s in _leaves_with_path(model_schema(cfg)))


def config_active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE experts scaled by top_k / E)."""
    from repro_torch.models.lm import model_schema

    total = 0
    m = cfg.moe
    for _, s in _leaves_with_path(model_schema(cfg)):
        n = int(np.prod(s.shape))
        if m is not None and "experts" in s.axes:
            n = int(n * m.top_k / m.num_experts)
        total += n
    return total


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS for the roofline table.

    train   → 6 · N_active · tokens      (fwd 2N + bwd 4N per token)
    prefill → 2 · N_active · tokens
    decode  → 2 · N_active · batch       (one token per sequence)
    """
    n_active = config_active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def attention_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Quadratic attention term excluded from 6·N·D (reported separately)."""
    a = cfg.attention
    n_attn_layers = sum(
        1 for b in (cfg.prefix_blocks + cfg.block_pattern * cfg.num_groups)
        if "attn" in b or b == "moe_layer"
    )
    if cfg.shared_attn_every:
        n_attn_layers += cfg.num_groups
    if a.kind == "none" or n_attn_layers == 0:
        return 0.0
    d_attn = a.num_heads * (a.head_dim if a.kind != "mla"
                            else (a.qk_nope_head_dim + a.qk_rope_head_dim))
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        per_layer = 2.0 * shape.global_batch * s * s * d_attn  # QK^T + PV
        if a.window:  # local layers see at most `window` keys
            per_layer = 2.0 * shape.global_batch * s * min(s, a.window) * d_attn
        f = per_layer * n_attn_layers
        return f * (3.0 if shape.kind == "train" else 1.0)
    # decode: one query against the full cache
    return 2.0 * shape.global_batch * shape.seq_len * d_attn * n_attn_layers
