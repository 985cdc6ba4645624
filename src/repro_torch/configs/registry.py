"""Architecture registry: ``--arch <id>`` resolution.

Each assigned architecture lives in its own module exposing ``CONFIG`` (the
full published geometry) and ``SMOKE`` (a reduced same-family config for CPU
smoke tests).  The full configs are only ever exercised through the dry-run
(ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
