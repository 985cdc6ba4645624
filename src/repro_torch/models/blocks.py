"""Block registry: maps block-pattern ids to (schema, cache_schema, apply)
— the counterpart of ``repro.models.blocks``.

The LM assembly (``repro_torch.models.lm``) is generic over this
registry — adding an architecture family means adding a block here plus
a config.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe, ssm, xlstm


@dataclass(frozen=True)
class BlockDef:
    schema: Callable[[ModelConfig], Dict]
    cache_schema: Callable[[ModelConfig, int, int], Dict]
    apply: Callable  # (params, x, ctx, cache) -> (x, new_cache, aux)


BLOCKS: Dict[str, BlockDef] = {
    "attn_mlp": BlockDef(
        schema=layers.attn_mlp_schema,
        cache_schema=layers.attn_mlp_cache_schema,
        apply=layers.apply_attn_mlp,
    ),
    "local_attn_mlp": BlockDef(
        schema=functools.partial(layers.attn_mlp_schema, local=True),
        cache_schema=functools.partial(layers.attn_mlp_cache_schema,
                                       local=True),
        apply=functools.partial(layers.apply_attn_mlp, local=True),
    ),
    "bidir_attn_mlp": BlockDef(  # whisper / frontend encoders
        schema=layers.attn_mlp_schema,
        cache_schema=lambda cfg, b, s: {},
        apply=functools.partial(layers.apply_attn_mlp, causal=False),
    ),
    "xattn_layer": BlockDef(  # decoder layer with cross-attention
        schema=functools.partial(layers.attn_mlp_schema, cross=True),
        cache_schema=functools.partial(layers.attn_mlp_cache_schema, cross=True),
        apply=functools.partial(layers.apply_attn_mlp, cross=True),
    ),
    "moe_layer": BlockDef(
        schema=moe.moe_layer_schema,
        cache_schema=moe.moe_layer_cache_schema,
        apply=moe.apply_moe_layer,
    ),
    "mamba2": BlockDef(
        schema=ssm.mamba2_schema,
        cache_schema=ssm.mamba2_cache_schema,
        apply=ssm.apply_mamba2,
    ),
    "mlstm": BlockDef(
        schema=xlstm.mlstm_schema,
        cache_schema=xlstm.mlstm_cache_schema,
        apply=xlstm.apply_mlstm,
    ),
    "slstm": BlockDef(
        schema=xlstm.slstm_schema,
        cache_schema=xlstm.slstm_cache_schema,
        apply=xlstm.apply_slstm,
    ),
}


def aux_keys(cfg: ModelConfig):
    """The fixed set of aux-metric keys blocks of this config may emit."""
    keys = []
    if cfg.moe is not None:
        keys += ["moe_aux_loss", "moe_frac_dropped"]
    return tuple(keys)


def effective_pattern(cfg: ModelConfig):
    """Decoder block pattern after family-level rewrites (whisper → x-attn)."""
    if cfg.encdec is not None:
        return tuple("xattn_layer" if b == "attn_mlp" else b
                     for b in cfg.block_pattern)
    return cfg.block_pattern


def effective_prefix(cfg: ModelConfig):
    if cfg.encdec is not None:
        return tuple("xattn_layer" if b == "attn_mlp" else b
                     for b in cfg.prefix_blocks)
    return cfg.prefix_blocks
