"""Grouped GEMM over the experts a mixture-of-experts layer holds: rows
sorted by expert, each expert's rows multiplied by its own weight, in one
launch per projection.

Source note
-----------
Replaces no TPU kernel: the JAX package's mixture of experts
(``src/repro/models/model.py::_moe_ffn``) drops slots past a capacity and
runs the experts as batched GEMMs of that capacity.  This kernel
(``csrc/grouped_gemm.cu``) serves the port's dropless layer
(``models/moe.py``), whose experts see as many rows as the router sends
them: a row block's expert is found from the offsets on the card, so no
size leaves the device and nothing is padded to a capacity.

    out[dst[r]] = scale[r] * (x[rows[r]] @ w[g])   for offsets[g] <= r < offsets[g + 1]

``rows`` gathers the source rows (the tokens of the sorted slots), ``dst``
scatters the results (back to slot order) and ``scale`` weighs each row (by
its gate); each is optional.  Rows at or past ``offsets[G]`` are neither
read nor written: the slots routed to experts this device does not hold.
``done``, an int64 scalar on the card, if given, gains the rows the launch
covered, so a caller can hold them to ``offsets[G]``.

What bounds it on an H100: at a prefill's row counts the bf16 multiply-add
rate (a row block of 128 against a weight slab of 4096 x 768 does ~100
flops a byte); at a decode step's few rows the bytes of the weights of the
experts that got rows.  What the design does about it (the ``.cu`` file's
header has the detail): bf16 ``mma.sync`` with f32 accumulators, 8 warps a
(BM x 128) output block, a 3-stage ``cp.async`` ring whose row tiles are
gathered as they are copied; the grid is sized by what the host knows,
``cdiv(R, BM) + G`` row blocks (each expert adds at most one ragged block),
and a block walks the G offsets to find its expert; blocks past the last
expert's, and experts with no rows, do nothing.

On a CPU tensor :func:`grouped_gemm` computes :func:`grouped_gemm_plain`,
which walks the kernel's row blocks (:func:`row_blocks`) and takes the
products in f32.  On a CUDA tensor it launches the kernel or raises: bf16
operands, K a multiple of 32, N of 8.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["grouped_gemm", "grouped_gemm_plain", "gemm_plan", "row_blocks",
           "launches"]

launches = 0
_count_lock = threading.Lock()

BN = 128  # output columns a block (csrc/grouped_gemm.cu)
BK = 32   # contraction depth of one pipeline stage


def gemm_plan(rows: int, groups: int) -> tuple[int, int]:
    """(row block, row blocks in the grid) for ``rows`` sorted rows over
    ``groups`` experts: 64-row blocks while an expert holds few rows (a
    decode step), else 128."""
    bm = 64 if rows <= 64 * groups else 128
    return bm, -(-rows // bm) + groups


def row_blocks(offsets: list, rows: int):
    """The kernel's row blocks over ascending ``offsets`` (G + 1 ints) of
    ``rows`` sorted rows, as (expert, first row, end row) triples: block
    ``b`` of the grid finds its expert by counting each expert's blocks of
    ``gemm_plan``'s size, and a block past the last expert's finds none."""
    G = len(offsets) - 1
    bm, grid_m = gemm_plan(rows, G)
    first = 0
    out = []
    for g in range(G):
        lo, hi = offsets[g], offsets[g + 1]
        nt = -(-(hi - lo) // bm) if hi > lo else 0
        for b in range(nt):
            if first + b < grid_m:
                out.append((g, lo + b * bm, min(lo + (b + 1) * bm, hi)))
        first += nt
    return out


def _check(x, w, offsets, rows, scale, dst, out):
    G, K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not meet w {tuple(w.shape)}")
    if offsets.shape != (G + 1,):
        raise ValueError(f"offsets {tuple(offsets.shape)} for {G} groups")
    R = x.shape[0] if rows is None else rows.shape[0]
    for name, t in (("scale", scale), ("dst", dst)):
        if t is not None and t.shape != (R,):
            raise ValueError(f"{name} {tuple(t.shape)} for {R} rows")
    if dst is not None and out is None:
        raise ValueError("dst needs the output it scatters into")
    return G, K, N, R


def grouped_gemm_plain(x, w, offsets, *, rows=None, scale=None, dst=None,
                       out=None, done=None):
    """The kernel's function in plain PyTorch: the kernel's row blocks
    (:func:`row_blocks`) one by one, the products in f32, each row scaled
    in f32 and rounded once to the output's type."""
    G, K, N, R = _check(x, w, offsets, rows, scale, dst, out)
    if out is None:
        out = x.new_zeros((R, N))
    covered = 0
    for g, lo, hi in row_blocks([int(v) for v in offsets.tolist()], R):
        src = x[lo:hi] if rows is None else x[rows[lo:hi].long()]
        acc = src.float() @ w[g].float()
        if scale is not None:
            acc = acc * scale[lo:hi, None].float()
        where = slice(lo, hi) if dst is None else dst[lo:hi].long()
        out[where] = acc.to(out.dtype)
        covered += hi - lo
    if done is not None:
        done += covered
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_gemm")
    fn = lib.grouped_gemm_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, *,
                 rows: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None,
                 dst: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 done: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K); w (G, K, N); offsets (G + 1,) int32, ascending, on x's
    device; rows, dst (R,) int32 and scale (R,) f32, each optional (R = M
    without ``rows``); ``done`` an int64 scalar the covered rows are added
    to.  Returns ``out``: (R, N) in x's type, or the ``out`` given, into
    which ``dst`` scatters (the rows nothing writes keep their values).
    Rows past ``offsets[G]`` are left as they are."""
    global launches
    G, K, N, R = _check(x, w, offsets, rows, scale, dst, out)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, offsets, rows=rows, scale=scale,
                                  dst=dst, out=out, done=done)
    if out is None:
        out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("offsets", offsets), ("rows", rows), ("dst", dst)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if scale is not None and scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if done is not None and (done.dtype != torch.int64 or done.numel() != 1):
        raise ValueError("done must be one int64")
    if out.shape[1] != N or K % BK or N % 8:
        raise ValueError(f"the kernel takes K % {BK} == 0 and N % 8 == 0: "
                         f"w {tuple(w.shape)}, out {tuple(out.shape)}")
    if R == 0:
        return out
    bm, grid_m = gemm_plan(R, G)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = _lib().grouped_gemm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr(rows),
            offsets.data_ptr(), ptr(scale), ptr(dst), ptr(done), N, K, G,
            x.stride(0), out.stride(0), bm, grid_m,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"R={R}, bm={bm}, grid_m={grid_m})")
    with _count_lock:
        launches += 1
    return out
