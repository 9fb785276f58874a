"""Architecture registry: one module per assigned architecture (the port's
copy of ``src/repro/configs/``; the names and values are the reference's).

``get_config(name)`` -> full-size ModelConfig (dry-run only — never allocate)
``get_smoke_config(name)`` -> reduced same-family config for CPU smoke tests
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    AudioConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    VisionConfig,
    XLSTMConfig,
    cell_is_applicable,
)

ARCH_IDS: List[str] = [
    "deepseek-moe-16b",
    "dbrx-132b",
    "llama-3.2-vision-11b",
    "hymba-1.5b",
    "glm4-9b",
    "minicpm3-4b",
    "internlm2-1.8b",
    "mistral-nemo-12b",
    "xlstm-350m",
    "whisper-base",
]

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "glm4-9b": "glm4_9b",
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "xlstm-350m": "xlstm_350m",
    "whisper-base": "whisper_base",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
