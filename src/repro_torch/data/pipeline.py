"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

No datasets ship with the repository, so the pipeline generates
reproducible token and image streams on the host with numpy, seeded, in
the same order and from the same generator calls as the reference, so the
two packages see the same batches.  The training loop moves each batch to
its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "ImageStream"]


@dataclasses.dataclass
class TokenStream:
    """Zipf-ish synthetic LM token stream: (tokens, labels) int32 batches
    of shape (batch, seq), labels the tokens shifted by one."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        # Zipf over the vocab, matching real token frequency skew
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        while True:
            flat = rng.choice(self.vocab, size=self.batch * (self.seq + 1),
                              p=probs)
            arr = flat.reshape(self.batch, self.seq + 1).astype(np.int32)
            yield arr[:, :-1], arr[:, 1:]

    def batches(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]


@dataclasses.dataclass
class ImageStream:
    """Synthetic NCHW f32 image batches with int32 class labels."""

    batch: int
    image: int = 32
    channels: int = 3
    n_classes: int = 10
    seed: int = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        while True:
            x = rng.standard_normal(
                (self.batch, self.channels, self.image, self.image)
            ).astype(np.float32)
            y = rng.integers(0, self.n_classes, size=(self.batch,),
                             dtype=np.int32)
            yield x, y
