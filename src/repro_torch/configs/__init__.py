"""Architecture config registry (``--arch <id>``): the reference's ten
architectures, in the reference's order (``ARCHS``), and the port's own
(granite-4.0-h-small)."""
from __future__ import annotations

import importlib

from ..models.model import ModelConfig
from .base import INPUT_SHAPES, InputShape, for_shape, smoke_variant, LONG_WINDOW

_MODULES = {
    "gemma-2b": "gemma_2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "minicpm-2b": "minicpm_2b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "musicgen-medium": "musicgen_medium",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "internvl2-1b": "internvl2_1b",
}

ARCHS = tuple(_MODULES)

# configurations of the port alone, beside the reference's ten: served and
# benchmarked, outside ``ARCHS`` (which lists the reference's)
_PORT_MODULES = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}

__all__ = ["ARCHS", "get_config", "smoke_config", "INPUT_SHAPES", "InputShape",
           "for_shape", "smoke_variant", "LONG_WINDOW"]


def get_config(arch: str) -> ModelConfig:
    name = _MODULES.get(arch) or _PORT_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(_PORT_MODULES)}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
