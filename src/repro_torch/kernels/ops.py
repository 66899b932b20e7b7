"""Public wrappers around the hand-written CUDA kernels.

Each wrapper launches its kernel for a CUDA tensor and computes the plain
PyTorch version (ref.py) for a CPU tensor; nothing else selects between the
two.  tests/test_torch_kernels.py holds the plain versions to the JAX
reference; chip_smoke.py holds the kernels to the plain versions on the
card.
"""
from __future__ import annotations

import torch

from .conv2d import conv2d
from .mds_decode import mds_decode_cuda
from .mds_encode import mds_encode_cuda

__all__ = ["mds_encode", "mds_decode", "conv2d_subtask"]


def mds_encode(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Encode k flattened partitions into n coded rows (paper eq. 3)."""
    return mds_encode_cuda(G, x)


def mds_decode(D: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Recover k source rows from received coded rows: D @ Y (paper eq. 4)."""
    return mds_decode_cuda(D, y)


def conv2d_subtask(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                   ) -> torch.Tensor:
    """One worker's conv subtask (C_I, H, W^p) -> (C_O, H_O, W_O^p)."""
    if x.dim() != 3:
        raise ValueError(f"need x (C_I, H, W_p), got {tuple(x.shape)}")
    return conv2d(x[None], w, stride)[0]
