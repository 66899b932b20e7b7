"""Plain PyTorch versions of every ported kernel (the allclose targets),
under the reference's names.  They live beside their kernels and are
re-exported here."""
from __future__ import annotations

import torch

from .conv2d import conv2d_plain
from .skinny_gemm import skinny_gemm_plain

__all__ = ["mds_encode_ref", "mds_decode_ref", "conv2d_ref"]


def mds_encode_ref(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n, k) @ (k, F) -> (n, F): the paper's encode GEMM (eq. 3)."""
    return skinny_gemm_plain(G, x)


def mds_decode_ref(D: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(k, m) @ (m, F) -> (k, F): the any-k decode GEMM (eq. 4)."""
    return skinny_gemm_plain(D, y)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1
               ) -> torch.Tensor:
    """VALID conv, CHW x OIHW -> OHW (single image — the worker subtask)."""
    return conv2d_plain(x[None], w, stride)[0]
