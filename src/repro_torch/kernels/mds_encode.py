"""MDS encode GEMM ``G (n, k) @ X (k, F) -> (n, F)`` (paper eq. 3).

The named entry point the reference keeps in ``kernels/mds_encode.py``; the
kernel itself is shared with the decode and lives in ``skinny_gemm.py``.
"""
from __future__ import annotations

import torch

from .skinny_gemm import skinny_gemm

__all__ = ["mds_encode_cuda"]


def mds_encode_cuda(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """G: (n, k), x: (k, F) -> (n, F): the encode GEMM."""
    return skinny_gemm(G, x)
