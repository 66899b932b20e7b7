"""Modality frontend stubs (the port of ``repro.models.frontends``).

The audio (EnCodec/mel+conv) and vision (InternViT) encoders are not
implemented, in the reference either: the [audio] and [vlm] architectures
take precomputed frame/patch embeddings of shape (B, T, d_model), and these
helpers generate deterministic synthetic ones for smoke tests and examples.

A ``torch.Generator`` gives other numbers than ``jax.random`` for the same
seed: parity tests hand the reference's embeddings across as numpy.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["synthetic_frames", "synthetic_patches"]


def _embeddings(gen: torch.Generator, batch: int, length: int, d_model: int,
                dtype, device) -> torch.Tensor:
    """N(0, 1) * 0.02 drawn in f32 from ``gen`` on the generator's device,
    cast to ``dtype`` and kept on ``device``."""
    dev = resolve_device(device)
    x = torch.randn((batch, length, d_model), generator=gen,
                    device=gen.device, dtype=torch.float32) * 0.02
    return x.to(device=dev, dtype=dtype)


def synthetic_frames(gen: torch.Generator, batch: int, frames: int,
                     d_model: int, dtype=torch.bfloat16, *,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Stand-in for EnCodec frame embeddings: (B, T, D)."""
    return _embeddings(gen, batch, frames, d_model, dtype, device)


def synthetic_patches(gen: torch.Generator, batch: int, patches: int,
                      d_model: int, dtype=torch.bfloat16, *,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Stand-in for InternViT patch embeddings after the projector:
    (B, T, D)."""
    return _embeddings(gen, batch, patches, d_model, dtype, device)
