"""Skinny GEMM ``A (m, b) @ X (b, F) -> (m, F)``: the coding GEMM and the
worker piece GEMM.

Source note
-----------
Replaces the Pallas TPU kernel ``src/repro/kernels/mds_encode.py::
skinny_gemm_pallas`` (body ``_gemm_kernel``), reached through
``mds_encode_pallas``, ``mds_decode_pallas`` and the executor's piece GEMM.

What bounds it on an H100: in the *coding* regime (m, b <= 16: every MDS/LT
encode and decode) the card's memory — ``(b + m) * F`` elements move and
each takes at most 16 multiply-adds.  In the *piece GEMM* regime (anything
larger) the f32 FMA rate.

What the design does about it (``csrc/skinny_gemm.cu``): coding — A lives in
shared memory, each thread owns one 16-byte group of neighbouring columns,
reads its b inputs once and writes m outputs, so every byte crosses the
memory bus exactly once in full-width transactions; a ragged F is masked by
a scalar variant, not padded and copied as the TPU kernel did.  Piece GEMM —
a 64 x 64 x 16 shared-memory tiled GEMM.  Both accumulate in f32 with plain
``fmaf`` in ascending order of the contraction index (no TF32, no tensor
cores), so an output element has the same value whichever block of F it is
computed in.  A is cast to X's dtype first (bf16 rounds the generator — the
reference does the same and parity depends on it); the output has X's dtype.

On a CPU tensor the wrapper computes :func:`skinny_gemm_plain`.  On a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["skinny_gemm", "skinny_gemm_plain", "SMALL"]

SMALL = 16  # m, b <= SMALL selects the coding kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def skinny_gemm_plain(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A cast to X's dtype, f32 product, X's dtype."""
    return (A.to(X.dtype).float() @ X.float()).to(X.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("skinny_gemm")
    fn = lib.skinny_gemm_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def skinny_gemm(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A: (m, b), X: (b, F) -> (m, F) in X's dtype, f32 accumulation."""
    if A.dim() != 2 or X.dim() != 2 or A.shape[1] != X.shape[0]:
        raise ValueError(f"need A (m, b) and X (b, F), got {tuple(A.shape)} "
                         f"and {tuple(X.shape)}")
    if A.device != X.device:
        raise ValueError(f"A is on {A.device}, X on {X.device}")
    if A.numel() == 0 or X.numel() == 0:
        raise ValueError(f"empty operand: A {tuple(A.shape)}, X "
                         f"{tuple(X.shape)}")
    if X.device.type == "cpu":
        return skinny_gemm_plain(A, X)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype not in _DTYPES:
        raise TypeError(f"skinny_gemm kernel takes float32 or bfloat16, got "
                        f"{X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    m, b = A.shape
    F = X.shape[1]
    if F >= 2 ** 31 or (m + 63) // 64 > 65535:
        raise ValueError(f"shape out of range for the kernel: m={m}, F={F}")
    A = A.to(X.dtype).contiguous()
    out = torch.empty((m, F), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().skinny_gemm_launch(
            A.data_ptr(), X.data_ptr(), out.data_ptr(), m, b, F,
            _DTYPES[X.dtype], stream)
    if err != 0:
        raise RuntimeError(f"skinny_gemm launch failed: CUDA error {err} "
                           f"(m={m}, b={b}, F={F}, {X.dtype})")
    with _count_lock:
        skinny_gemm.launches += 1
    return out


skinny_gemm.launches = 0  # kernel launches so far (not plain-version calls)
