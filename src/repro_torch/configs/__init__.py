"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Only the archs the port can run are listed; every other arch of the
reference registry raises ``NotImplementedError`` until its slice lands.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SplitConfig

_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

#: archs of the reference registry the port does not run yet
_NOT_PORTED = (
    "musicgen-large", "stablelm-3b", "llava-next-34b", "phi3.5-moe-42b-a6.6b",
    "mixtral-8x7b", "internlm2-20b", "granite-8b",
    "xlstm-125m", "lumos5g-lstm",
)

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = ["ARCH_IDS", "ModelConfig", "SplitConfig", "get_config",
           "get_reduced"]
