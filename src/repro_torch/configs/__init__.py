"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The same archs as the reference registry, in its order.
``lumos5g-lstm`` is the paper's own proof of concept (an ``LSTMConfig``,
trained by ``repro_torch.examples.throughput_prediction``); like the
reference it stays out of ``ARCH_IDS``, the archs the serving entry point
offers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (LSTMConfig, ModelConfig, ShapeConfig,
                                      SplitConfig)
from repro_torch.configs.shapes import SHAPES, get_shape

_MODULES: Dict[str, str] = {
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "lumos5g-lstm": "repro_torch.configs.lumos5g_lstm",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "lumos5g-lstm"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = ["ARCH_IDS", "SHAPES", "LSTMConfig", "ModelConfig", "ShapeConfig",
           "SplitConfig", "get_config", "get_reduced", "get_shape"]
