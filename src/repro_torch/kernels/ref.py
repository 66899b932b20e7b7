"""Plain PyTorch versions of every ported kernel (the allclose targets),
under the reference's names.  They live beside their kernels and are
re-exported here, with the SSD chunk's sequential-scan oracle."""
from __future__ import annotations

import torch

from .conv2d import conv2d_plain
from .skinny_gemm import skinny_gemm_plain

__all__ = ["mds_encode_ref", "mds_decode_ref", "conv2d_ref", "ssd_chunk_ref"]


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


def ssd_chunk_ref(x, dt, A, Bm, Cm, h0):
    """One SSD chunk, sequential-scan oracle.

    x: (L, H, P); dt: (L, H); A: (H,); Bm/Cm: (L, N); h0: (H, P, N).
    Returns (y: (L, H, P) in x's dtype, h_final).  The recurrence runs in
    f32, or in f64 when the inputs are f64.
    """
    ct = torch.promote_types(torch.promote_types(x.dtype, h0.dtype),
                             torch.float32)
    x_, dt_, A_, B_, C_ = (t.to(ct) for t in (x, dt, A, Bm, Cm))
    h = h0.to(ct)
    ys = []
    for t in range(x.shape[0]):
        decay = torch.exp(dt_[t] * A_)                       # (H,)
        h = h * decay[:, None, None] + torch.einsum(
            "h,n,hp->hpn", dt_[t], B_[t], x_[t])
        ys.append(torch.einsum("n,hpn->hp", C_[t], h))
    return torch.stack(ys).to(x.dtype), h
