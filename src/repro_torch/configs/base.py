"""Config registry substrate: input shapes and smoke reduction (the port of
``repro.configs.base``).

Every ported architecture gets one module defining ``CONFIG`` (the exact
full-scale ModelConfig from its source paper or model card).  The four
input shapes are:

    train_4k       seq=4096    global_batch=256   (train_step)
    prefill_32k    seq=32768   global_batch=32    (prefill)
    decode_32k     seq=32768   global_batch=128   (serve_step, 1 new token)
    long_500k      seq=524288  global_batch=1     (serve_step, 1 new token)
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.model import ModelConfig

__all__ = ["INPUT_SHAPES", "InputShape", "for_shape", "smoke_variant",
           "LONG_WINDOW"]

LONG_WINDOW = 8192  # sliding window used by dense archs for long_500k


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific config adjustments.

    * long_500k + full-attention arch -> sliding-window variant (SSM and
      hybrid archs are untouched).
    * training enables per-layer remat.
    """
    if shape.name == "long_500k" and cfg.block == "attn" and not cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=256, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    repl = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 1024),
        head_dim=min(cfg.hd, 64),
        dtype=torch.float32,
        ssm_chunk=16,
    )
    if cfg.is_moe:
        repl.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.block == "mamba":
        repl.update(ssm_state=min(cfg.ssm_state, 32), ssm_head_dim=32)
    if cfg.shared_attn_period:
        repl.update(shared_attn_period=1)
    if cfg.sliding_window:
        repl.update(sliding_window=8)
    return dataclasses.replace(cfg, **repl)
