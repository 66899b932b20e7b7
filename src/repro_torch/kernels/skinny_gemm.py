"""Skinny GEMM ``A (m, b) @ X (b, F) -> (m, F)``: the coding GEMM and the
worker piece GEMM.

Source note
-----------
Replaces the Pallas TPU kernel ``src/repro/kernels/mds_encode.py::
skinny_gemm_pallas`` (body ``_gemm_kernel``), reached through
``mds_encode_pallas``, ``mds_decode_pallas`` and the executor's piece GEMM.

Three regimes (``csrc/skinny_gemm.cu``), chosen by :func:`piece_plan`:

* *coding* (m, b <= 16: every MDS/LT encode and decode) — bound by bytes:
  ``(b + m) * F`` elements move and each output takes at most 16
  multiply-adds, far below the f32 ridge point, so no tensor cores.  A
  lives in shared memory as f32.  :func:`coding_plan` picks one of two
  variants from (F, dtype, alignment):

  - ``narrow`` (aligned X and output, F a whole number of 16-byte groups:
    every served model's encode and decode) — one group of neighbouring
    columns a thread in blocks of 128, X's b loads issued before A is
    staged.  Many small blocks keep the most bytes in flight; on an H100 it
    comes within a few percent of a device copy of the same bytes once F
    reaches a few 1e5, and it beat a persistent grid fed by a ring of bulk
    copies (TMA) at every aligned F measured, 2048 to 5.6M columns
    (PERF.md).
  - ``scalar`` (an unaligned pointer, or a ragged F, whose rows start off
    16-byte boundaries) — one column a thread, grid-stride.

  Both compute an output as one fmaf chain from 0 over the b inputs in
  ascending order, so they give the same bits (those the coding regime
  always gave); a ragged end is masked, never padded and copied as the TPU
  kernel did.
* *GEMV* (m <= 16 < b: the decode-step pieces, t_p = 1) — bound by bytes,
  the ``b x F`` weight is read once.  A block owns 32 column groups (a warp
  reads 512 contiguous bytes of a row); its 256 threads are 32 groups x 8
  contraction lanes with 16 (or 8) 16-byte loads in flight each, and the
  contraction is split over the lanes and over the blocks of a
  thread-block cluster (:func:`gemv_splits`, a function of b alone), the
  partials summed in a fixed order through shared and distributed shared
  memory.
* *tiled* (m > 16: the prefill pieces) — bound by the f32 FMA rate.  The
  pipelined register-blocked mainloop of ``csrc/sgemm_mainloop.cuh`` (a
  4-stage cp.async ring, 8 x 8 or 4 x 4 outputs per thread), each output one
  ascending fmaf chain, so the tile follows the shape (``_tiles.pick_tile``).

:func:`piece_gemm_stacked` runs the n coded pieces of one run, ``(n, t_p,
b)`` against one X, in one launch (the one-program backend,
``dist/mesh_exec.py``).  Its regime is one piece's, chosen by t_p
(:func:`stacked_plan`): at t_p <= 16 the coding or GEMV regime over the
stacked rows, 16 (GEMV: MR) to a row group on grid.y, so a decode step's
ten t_p = 1 pieces read the weight once instead of ten times; above, the
tiled regime on the ``(n * t_p, b)`` stack.  Every output has the bits of
its piece launched alone through :func:`skinny_gemm`, because a row's
reduction order depends on the regime and b only.

All accumulate in f32 with plain ``fmaf`` (no TF32, no tensor cores: TF32
breaks the numerics, and a 3xTF32 or bf16 ``wgmma`` design is its own
work).  The reduction order of an output element depends on the regime and
on b only, so an element has the same bits whichever block of F it is
computed in.  A is cast to X's dtype first (bf16 rounds the generator — the
reference does the same and parity depends on it); the output has X's dtype.

On a CPU tensor the wrapper computes :func:`skinny_gemm_plain`.  On a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from . import _build, _tiles
from ._tiles import LaunchPlan

__all__ = ["skinny_gemm", "skinny_gemm_plain", "piece_plan", "gemv_splits",
           "coding_plan", "coding_variant_plan",
           "piece_gemm_stacked", "piece_gemm_stacked_plain", "stacked_plan",
           "SMALL"]

SMALL = 16  # m, b <= SMALL selects the coding kernel; m <= SMALL the GEMV
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REGIMES = {"coding": 0, "gemv": 1, "tiled": 2}
_count_lock = threading.Lock()

# the coding regime's variants (csrc/skinny_gemm.cu): narrow blocks of
# NARROW_THREADS 16-byte groups; scalar blocks of SCALAR_THREADS columns
NARROW_THREADS = 128
SCALAR_THREADS, SCALAR_MAX_BLOCKS = 256, 65536
CODING_STATIC = 4 * SMALL * SMALL  # A as f32, static shared memory
GEMV_THREADS, GEMV_GROUPS = 256, 32
GEMV_ROWS_PER_SPLIT = 1024  # contraction rows one cluster rank streams, about


def skinny_gemm_plain(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A cast to X's dtype, f32 product, X's dtype."""
    return (A.to(X.dtype).float() @ X.float()).to(X.dtype)


@functools.lru_cache(maxsize=None)
def _group(dtype: torch.dtype) -> int:
    """Elements in one 16-byte group."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def gemv_splits(b: int) -> tuple:
    """The GEMV regime's contraction ranges: about 1024 rows per cluster
    rank, at most 8 ranks.  A function of b alone."""
    return _tiles.split_ranges(b, -(-b // GEMV_ROWS_PER_SPLIT))


def coding_variant_plan(variant: str, b: int, F: int, dtype=torch.float32
                        ) -> LaunchPlan:
    """The coding regime's launch of one variant for ``(m <= 16, b) @ (b,
    F)``; :func:`coding_plan` picks the variant.  Neither depends on m."""
    if variant == "narrow":
        V = _group(dtype)
        if F % V:
            raise ValueError(f"narrow needs whole 16-byte rows: F={F}")
        grid = (-(-F // (NARROW_THREADS * V)), 1)
        return LaunchPlan("coding", 0, (NARROW_THREADS * V,), NARROW_THREADS,
                          ((0, b),), grid, 0, CODING_STATIC,
                          _tiles.fill_note(grid[0], "F is small: one "
                                           "16-byte group a thread, bound "
                                           "by latency"))
    if variant == "scalar":
        grid = (min(-(-F // SCALAR_THREADS), SCALAR_MAX_BLOCKS), 1)
        return LaunchPlan("coding", 1, (SCALAR_THREADS,), SCALAR_THREADS,
                          ((0, b),), grid, 0, CODING_STATIC,
                          _tiles.fill_note(grid[0], "F is small"))
    raise ValueError(f"unknown coding variant {variant!r}")


def coding_plan(m: int, b: int, F: int, dtype=torch.float32,
                aligned: bool = True) -> LaunchPlan:
    """How the coding product ``A (m, b) @ X (b, F)`` (m, b <= 16) is
    launched: ``narrow`` when X and the output are 16-byte aligned and F
    fills 16-byte groups (every served model's encode and decode), else
    ``scalar``.  A function of (b, F, dtype, aligned); m does not change
    it."""
    if min(m, b, F) < 1:
        raise ValueError(f"empty product: m={m}, b={b}, F={F}")
    if m > SMALL or b > SMALL:
        raise ValueError(f"not a coding product: m={m}, b={b} (> {SMALL})")
    whole = F % _group(dtype) == 0
    return coding_variant_plan("narrow" if aligned and whole else "scalar",
                               b, F, dtype)


@functools.lru_cache(maxsize=4096)
def piece_plan(m: int, b: int, F: int, dtype=torch.float32,
               aligned: bool = True) -> LaunchPlan:
    """How ``A (m, b) @ X (b, F)`` is launched: regime, tile, split,
    cluster, grid and shared memory.  ``aligned``: X and the output start
    on 16-byte boundaries (only the coding regime's variant reads it)."""
    if min(m, b, F) < 1:
        raise ValueError(f"empty product: m={m}, b={b}, F={F}")
    V = _group(dtype)
    if m <= SMALL and b <= SMALL:
        return coding_plan(m, b, F, dtype, aligned)
    if m <= SMALL:
        mr = 1 << (m - 1).bit_length()
        splits = gemv_splits(b)
        width = GEMV_GROUPS * V
        grid = (-(-F // width) * len(splits), 1)
        lanes = GEMV_THREADS // GEMV_GROUPS
        tk = lanes * (16 if mr * V <= 32 else 8)  # rows of A staged per tile
        shared = 4 * (mr * tk + lanes * width + mr * width)
        return LaunchPlan("gemv", mr.bit_length() - 1, (mr, width),
                          GEMV_THREADS, splits, grid, 0, shared,
                          _tiles.fill_note(grid[0], f"{len(splits)} split(s) "
                                           f"of b={b} x {-(-F // width)} "
                                           "column slabs; bound by bytes, "
                                           "and narrower slabs measured "
                                           "slower"))
    config, grid = _tiles.pick_tile(m, F, 1, 2 * _tiles.N_SMS)
    tile = _tiles.TILES[config]
    smem = _tiles.tile_smem(tile)
    return LaunchPlan("tiled", config, tile, _tiles.tile_threads(tile),
                      ((0, b),), grid, smem, smem,
                      _tiles.fill_note(grid[0] * grid[1], "the smallest tile "
                                       "leaves the card part idle; each "
                                       "output is one unsplit chain"))


@functools.lru_cache(maxsize=4096)
def stacked_plan(n: int, t_p: int, b: int, F: int, dtype=torch.float32,
                 aligned: bool = True) -> LaunchPlan:
    """How ``pieces (n, t_p, b) @ X (b, F)`` is launched: one piece's
    regime (by t_p), over all ``n * t_p`` rows.  At t_p <= 16 the coding
    or GEMV plan of one row group (16 rows, or the stack if smaller) with
    ``grid[1]`` row groups; above, the tiled plan of the whole stack."""
    if min(n, t_p) < 1:
        raise ValueError(f"empty stack: n={n}, t_p={t_p}")
    rows = n * t_p
    if t_p > SMALL:
        return piece_plan(rows, b, F, dtype, aligned)
    plan = piece_plan(min(rows, SMALL), b, F, dtype, aligned)
    group = SMALL if plan.regime == "coding" else plan.tile[0]
    groups = -(-rows // group)
    grid = (plan.grid[0], groups)
    return dataclasses.replace(
        plan, grid=grid,
        note=_tiles.fill_note(grid[0] * grid[1], f"{groups} row group(s) of "
                              f"{group} x {plan.grid[0]} blocks"))


def piece_gemm_stacked_plain(pieces: torch.Tensor, X: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version: :func:`skinny_gemm_plain` piece by piece, so
    each piece has the bits of its own plain product."""
    return torch.stack([skinny_gemm_plain(p, X) for p in pieces])


def _lib() -> ctypes.CDLL:
    lib = _build.load("skinny_gemm")
    fn = lib.skinny_gemm_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(A: torch.Tensor, X: torch.Tensor, plan: LaunchPlan
            ) -> torch.Tensor:
    """Launch ``plan`` for ``A (m, b) @ X (b, F)`` (CUDA, X checked)."""
    m, b = A.shape
    F = X.shape[1]
    if F >= 2 ** 31 or plan.grid[1] > 65535 or plan.grid[0] >= 2 ** 31:
        raise ValueError(f"shape out of range for the kernel: m={m}, F={F}")
    A = A.to(X.dtype).contiguous()
    out = torch.empty((m, F), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        groups = plan.grid[1] if plan.regime != "tiled" else 1
        err = _lib().skinny_gemm_launch(
            A.data_ptr(), X.data_ptr(), out.data_ptr(), m, b, F,
            _DTYPES[X.dtype], _REGIMES[plan.regime], plan.config,
            plan.cluster, plan.chunk, plan.smem_bytes, groups, plan.threads,
            plan.grid[0], stream)
    if err != 0:
        raise RuntimeError(f"skinny_gemm launch failed: CUDA error {err} "
                           f"(m={m}, b={b}, F={F}, {X.dtype}, {plan})")
    return out


def _check_x(X: torch.Tensor) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype not in _DTYPES:
        raise TypeError(f"skinny_gemm kernel takes float32 or bfloat16, got "
                        f"{X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")


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
    _check_x(X)
    m, b = A.shape
    out = _launch(A, X, piece_plan(m, b, X.shape[1], X.dtype,
                                   X.data_ptr() % 16 == 0))
    with _count_lock:
        skinny_gemm.launches += 1
    return out


skinny_gemm.launches = 0  # kernel launches so far (not plain-version calls)


def piece_gemm_stacked(pieces: torch.Tensor, X: torch.Tensor
                       ) -> torch.Tensor:
    """pieces: (n, t_p, b), X: (b, F) -> (n, t_p, F) in X's dtype, all n
    pieces in one launch, each with the bits of ``skinny_gemm(piece, X)``."""
    if pieces.dim() != 3 or X.dim() != 2 or pieces.shape[2] != X.shape[0]:
        raise ValueError(f"need pieces (n, t_p, b) and X (b, F), got "
                         f"{tuple(pieces.shape)} and {tuple(X.shape)}")
    if pieces.device != X.device:
        raise ValueError(f"pieces are on {pieces.device}, X on {X.device}")
    if pieces.numel() == 0 or X.numel() == 0:
        raise ValueError(f"empty operand: pieces {tuple(pieces.shape)}, X "
                         f"{tuple(X.shape)}")
    if X.device.type == "cpu":
        return piece_gemm_stacked_plain(pieces, X)
    _check_x(X)
    n, t_p, b = pieces.shape
    F = X.shape[1]
    out = _launch(pieces.reshape(n * t_p, b), X,
                  stacked_plan(n, t_p, b, F, X.dtype, X.data_ptr() % 16 == 0))
    with _count_lock:
        piece_gemm_stacked.launches += 1
    return out.view(n, t_p, F)


piece_gemm_stacked.launches = 0  # kernel launches (not plain-version calls)
