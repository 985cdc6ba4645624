"""Per-(arch × shape) run presets: microbatching, remat, moment dtype —
the counterpart of ``repro.launch.presets`` (the same table: it was sized
for the reference's accelerator, and the port keeps it so a run means
the same thing in both packages).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import (
    InputShape,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    SHAPES_BY_NAME,
)
from repro_torch.configs.registry import get_config

# arch → (train microbatches, moment dtype)
_TRAIN_PRESETS: Dict[str, Dict] = {
    "zamba2-7b": dict(microbatches=8),
    "internvl2-2b": dict(microbatches=2),
    "granite-8b": dict(microbatches=4),
    "yi-6b": dict(microbatches=4),
    "nemotron-4-15b": dict(microbatches=8),  # 256k-vocab logits dominate
    "gemma2-9b": dict(microbatches=4),
    "whisper-tiny": dict(microbatches=8),    # logits [B,S,52k] dominate
    "xlstm-125m": dict(microbatches=1),
    "arctic-480b": dict(microbatches=8, moment_dtype="bfloat16"),
    "deepseek-v2-236b": dict(microbatches=8, moment_dtype="bfloat16"),
}


def make_run_config(
    arch: str,
    shape_name: str,
    *,
    overrides: Optional[Dict] = None,
    model_config: Optional[ModelConfig] = None,
) -> RunConfig:
    cfg = model_config if model_config is not None else get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    preset = dict(_TRAIN_PRESETS.get(arch, {}))
    preset.update(overrides or {})
    moment_dtype = preset.pop("moment_dtype", "float32")
    micro = preset.pop("microbatches", 1) if shape.kind == "train" else 1
    opt = OptimizerConfig(moment_dtype=moment_dtype)
    run = RunConfig(model=cfg, shape=shape, optimizer=opt, microbatches=micro)
    if preset:
        run = run.replace(**preset)
    return run
