"""Direct VALID 2-D convolution: the worker's conv subtask, and every other
convolution of the CNN path.

Source note
-----------
Replaces the Pallas TPU kernel ``src/repro/kernels/conv2d.py::conv2d_pallas``
(body ``_conv_kernel``).  That kernel takes one image ``(C_I, H, W_p)``, holds
it whole in fast memory and tiles output channels; this one takes the batch
``(N, C_I, H, W_p)`` — the n coded pieces of the functional pipeline fold
into N — and :func:`repro_torch.kernels.ops.conv2d_subtask` is its N = 1 view.

What bounds it on an H100: the f32 FMA rate (at VGG16 widths each byte
moved feeds hundreds of multiply-adds).

What the design does about it (``csrc/conv2d.cu``): implicit GEMM
``out (C_O, P) = w (C_O, R) @ patch (R, P)`` with ``R = C_I*K*K`` and
``P = N*H_O*W_O``, run by the pipelined register-blocked mainloop that the
skinny GEMM's tiled regime shares (``csrc/sgemm_mainloop.cuh``: a 4-stage
cp.async ring, the weight staged K-major, the patch gathered on the fly by
4-byte copies with zero fill at the edges, 8 x 8 or 4 x 4 outputs per
thread).  No im2col buffer exists.  VGG16's coded pieces are narrow, so the
(C_O, P) tiles alone leave the deep layers with a handful of blocks:
:func:`conv_plan` splits R over a thread-block cluster of up to 8 blocks
(:func:`conv_splits`, a function of the weight's shape only), each rank
sums its range as one ascending chain and the partials are added in rank
order through distributed shared memory — so every output element has one
reduction order whatever N, H, W or the tile, and n stacked pieces give the
bits of n separate launches.  All edges are masked: any C_O, K and stride.
Inputs are upcast to f32, accumulated with plain ``fmaf`` (no TF32),
rounded once to x's dtype.

Width slices: x is read through its strides, so ``x[..., a:b]`` is not
copied; w is made contiguous if it is not; the output is contiguous.

:func:`conv2d_stacked` takes the n coded pieces of one run, ``(n, N, C_I, H,
W_p)``, and folds them into N: one launch, each piece with the bits of its
own launch (the one-program backend, ``dist/mesh_exec.py``).

On a CPU tensor the wrappers compute :func:`conv2d_plain` (piece by piece
for :func:`conv2d_stacked`: ``F.conv2d`` on the CPU gives a folded batch
other bits than one image).  On a CUDA tensor they launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import _build, _tiles
from ._tiles import LaunchPlan

__all__ = ["conv2d", "conv2d_plain", "conv2d_stacked", "conv2d_stacked_plain",
           "conv_plan", "conv_splits"]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                 ) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` in f32, cast to x's dtype."""
    return F.conv2d(x.float(), w.float(), stride=stride).to(x.dtype)


def conv_splits(w_shape) -> tuple:
    """The R-split: ascending ranges of ``R = C_I*K*K``.  By the
    multiply-adds one output pixel takes (``C_O * R``): 1 range below 2^17,
    2 below 2^20, else 8 (VGG16: conv1_x and conv2_1 unsplit, conv2_2 to
    conv3_3 in 2, conv4_x and conv5_x in 8 — the best counts in timings of
    1, 2, 4 and 8 at their pieces on an H100).  A function of the weight's
    shape only, never of the input's."""
    c_out, c_in, K, _ = w_shape
    R = c_in * K * K
    work = c_out * R
    return _tiles.split_ranges(R, 1 if work < 1 << 17 else
                               2 if work < 1 << 20 else _tiles.MAX_SPLIT)


def conv_plan(x_shape, w_shape, stride: int = 1, dtype=torch.float32
              ) -> LaunchPlan:
    """How ``conv2d(x, w, stride)`` is launched: tile, R-split, cluster,
    grid and shared memory.  (Both dtypes take the same plan.)"""
    N, _, h_in, w_in = x_shape
    c_out, _, K, _ = w_shape
    P = N * ((h_in - K) // stride + 1) * ((w_in - K) // stride + 1)
    splits = conv_splits(w_shape)
    # about one block per SM; a 128 x 128 partial tile summed over 4 or more
    # ranks costs more through distributed shared memory than it saves
    config, grid = _tiles.pick_tile(c_out, P, len(splits), 128,
                                    first=int(len(splits) >= 4))
    tile = _tiles.TILES[config]
    # the ring, then one int offset of x per contraction row of a split
    smem = _tiles.tile_smem(tile) + 4 * (splits[0][1] - splits[0][0])
    return LaunchPlan("conv", config, tile, _tiles.tile_threads(tile),
                      splits, grid, smem, smem,
                      _tiles.fill_note(grid[0] * grid[1],
                                       f"C_O={c_out} x P={P} in the smallest "
                                       f"tile, R split {len(splits)} ways "
                                       f"(at most {_tiles.MAX_SPLIT})"))


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d")
    fn = lib.conv2d_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (N, C_I, H_I, W_I), w: (C_O, C_I, K, K) -> (N, C_O, H_O, W_O)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"need x (N, C, H, W) and w (O, I, K, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, c_in, h_in, w_in = x.shape
    c_out, c_in2, K, K2 = w.shape
    stride = int(stride)
    if c_in != c_in2 or K != K2 or stride < 1:
        raise ValueError(f"mismatched conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, stride {stride}")
    if h_in < K or w_in < K:
        raise ValueError(f"input {h_in}x{w_in} smaller than kernel {K}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype}, w is {w.dtype}")
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv2d kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    h_out = (h_in - K) // stride + 1
    w_out = (w_in - K) // stride + 1
    plan = conv_plan(x.shape, w.shape, stride, x.dtype)
    sn, sc, sh, sw = x.stride()
    # the kernel keeps the offset of a contraction row within an image as int
    if N * h_out * w_out >= 2 ** 31 or plan.grid[1] > 65535 \
            or plan.grid[0] >= 2 ** 31 \
            or (c_in - 1) * sc + (K - 1) * (sh + sw) >= 2 ** 31:
        raise ValueError(f"shape out of range for the kernel: {tuple(x.shape)}")
    w = w.contiguous()
    out = torch.empty((N, c_out, h_out, w_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().conv2d_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), N, c_in, c_out,
            h_out, w_out, K, stride, sn, sc, sh, sw,
            _DTYPES[x.dtype], plan.config, plan.cluster, plan.chunk,
            plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"conv2d launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"stride {stride}, {x.dtype}, {plan})")
    with _count_lock:
        conv2d.launches += 1
    return out


conv2d.launches = 0  # kernel launches so far (not plain-version calls)


def conv2d_stacked_plain(pieces: torch.Tensor, w: torch.Tensor,
                         stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: :func:`conv2d_plain` piece by piece."""
    return torch.stack([conv2d_plain(p, w, stride) for p in pieces])


def conv2d_stacked(pieces: torch.Tensor, w: torch.Tensor, stride: int = 1
                   ) -> torch.Tensor:
    """pieces: (n, N, C_I, H_I, W_I) -> (n, N, C_O, H_O, W_O): one
    :func:`conv2d` launch on the ``n * N`` folded batch.  The R-split is a
    function of the weight alone, so each piece has the bits of its own
    launch."""
    if pieces.dim() != 5:
        raise ValueError(f"need pieces (n, N, C, H, W), got "
                         f"{tuple(pieces.shape)}")
    if pieces.device.type == "cpu":
        return conv2d_stacked_plain(pieces, w, stride)
    n, N = pieces.shape[:2]
    out = conv2d(pieces.reshape((n * N,) + tuple(pieces.shape[2:])), w,
                 stride)
    return out.view((n, N) + tuple(out.shape[1:]))
