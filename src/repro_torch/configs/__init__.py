"""Architecture config registry (``--arch <id>``).

Only the configurations whose every module is ported are registered; the
reference's others (gemma-2b, minicpm-2b, dbrx-132b, qwen3-32b,
deepseek-coder-33b, musicgen-medium, kimi-k2-1t-a32b, internvl2-1b) wait
for MoE, the frontends and the remaining attention forms (ROADMAP.md,
Queue A item 8).
"""
from __future__ import annotations

import importlib

from ..models.model import ModelConfig
from .base import INPUT_SHAPES, InputShape, for_shape, smoke_variant, LONG_WINDOW

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-2.7b": "mamba2_2p7b",
}

ARCHS = tuple(_MODULES)

__all__ = ["ARCHS", "get_config", "smoke_config", "INPUT_SHAPES", "InputShape",
           "for_shape", "smoke_variant", "LONG_WINDOW"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
