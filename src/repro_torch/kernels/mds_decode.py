"""MDS decode GEMM ``D (k, m) @ Y (m, F) -> (k, F)`` (paper eq. 4).

The mirror image of the encode: a tiny decode matrix (Vandermonde inverse
or LT pseudo-inverse, cached host-side) against the flattened worker
outputs.  One kernel body (``skinny_gemm.py``), two named entry points.
"""
from __future__ import annotations

import torch

from .skinny_gemm import skinny_gemm

__all__ = ["mds_decode_cuda"]


def mds_decode_cuda(D: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """D: (k, m), y: (m, F) -> (k, F): the any-k decode GEMM."""
    return skinny_gemm(D, y)
