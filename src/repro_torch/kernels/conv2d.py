"""Direct VALID 2-D convolution: the worker's conv subtask, and every other
convolution of the CNN path.

Source note
-----------
Replaces the Pallas TPU kernel ``src/repro/kernels/conv2d.py::conv2d_pallas``
(body ``_conv_kernel``).  That kernel takes one image ``(C_I, H, W_p)``, holds
it whole in fast memory and tiles output channels; this one takes the batch
``(N, C_I, H, W_p)`` — the n coded pieces of the functional pipeline fold
into N — and :func:`repro_torch.kernels.ops.conv2d_subtask` is its N = 1 view.

What bounds it on an H100: the tensor cores' TF32 rate (at VGG16 widths
each byte moved feeds hundreds of multiply-adds).

What the design does about it (``csrc/conv2d.cu``): implicit GEMM
``out^T (P, C_O) = patch (P, R) @ w^T`` with ``R = C_I*K*K`` and
``P = N*H_O*W_O`` on the tensor cores: two warpgroups a block of 128 pixels x
128 (or 64) channels issue ``wgmma`` m64nNk8 in TF32, each f32 product taken
as hi*hi + hi*lo + lo*hi (3xTF32, hi and lo the TF32 roundings of v and
v - hi; bf16 inputs are exact in TF32 and take hi*hi alone).  A small
kernel splits the weight into hi and lo, laid out as the kernel's ring holds
it (:func:`split_w_floats` floats), so its stages reach shared memory by
plain copies; the split is made once for a weight and a tile and kept while
the weight lives and is not written to (:func:`split_weight`), so the n
pieces of a coded layer and every later request share it.  Each thread
gathers its own part of the patch
into registers, with zero fill at the edges, and splits it there: no im2col
buffer exists.  Every stage of 32 contraction rows is summed apart and added
to the running f32 sum in order.  VGG16's coded pieces are narrow, so the
(P, C_O) tiles alone leave the deep layers with few blocks: :func:`conv_plan`
may split R over a thread-block cluster of up to 8 blocks
(:func:`conv_splits`, a function of the weight's shape only), each rank sums
its range as above and the partials are added in rank order through
distributed shared memory — so every output element has one reduction order
whatever N, H, W or the tile, and n stacked pieces give the bits of n
separate launches.  All edges are masked: any C_O, K and stride.  Rounded
once to x's dtype.

Width slices: x is read through its strides, so ``x[..., a:b]`` is not
copied; w is read once, by its split (made from a contiguous copy if it is
not contiguous); the output is contiguous.

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
import weakref

import torch
import torch.nn.functional as F

from . import _build, _tiles
from ._tiles import LaunchPlan

__all__ = ["conv2d", "conv2d_plain", "conv2d_stacked", "conv2d_stacked_plain",
           "conv_plan", "conv_splits", "CONV_TILES", "ring_bytes",
           "split_w_floats", "split_weight"]

# mirrors of csrc/conv2d.cu: pixels a block, contraction rows a stage, ring
# depth, threads, and the output-channel widths a block may take (by index)
BM, BK, STAGES, THREADS = 128, 32, 3, 256
CONV_TILES = (128, 64)
# the most contraction rows one rank's offset table may hold beside the
# widest ring
MAX_CHUNK = (_tiles.SMEM_LIMIT - 2 * STAGES * CONV_TILES[0] * BK * 4
             ) // 4 // BK * BK


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# the split weights kept: (id of the weight tensor, tile index) -> _Split.
# Re-entrant: an entry is dropped from the weight's finaliser, which the
# garbage collector may run in this thread while the lock is held.
_splits: dict = {}
_splits_lock = threading.RLock()


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                 ) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` in f32, cast to x's dtype."""
    return F.conv2d(x.float(), w.float(), stride=stride).to(x.dtype)


def ring_bytes(bn: int) -> int:
    """Shared bytes of the ring for a block ``bn`` channels wide: STAGES x
    the hi and the lo weight tile of ``bn`` channels x BK rows of R, f32."""
    return STAGES * 2 * bn * BK * 4


def split_w_floats(w_shape, bn: int) -> int:
    """Floats of the split weight the kernel reads: for each tile of ``bn``
    channels and each stage of BK rows of R, its hi and lo tiles."""
    c_out, c_in, K, _ = w_shape
    return -(-c_out // bn) * -(-(c_in * K * K) // BK) * 2 * bn * BK


def conv_splits(w_shape) -> tuple:
    """The R-split: ascending ranges of ``R = C_I*K*K``, whole stages of BK
    rows each.  By the multiply-adds one output pixel takes (``C_O * R``):
    1 range below 2^21, else 2 (VGG16: conv4_2 to conv5_3 in 2, the rest
    unsplit), and at least enough that a range's offset table fits beside
    the ring.  At a batch of 128 the pool's concurrent pieces fill the card
    unsplit, and a split costs its partial tiles' sum (2 ranges cost conv4_2
    and conv5_x ~5% there, an H100's timings) but halves a lone small
    piece's time.  A function of the weight's shape only, never of the
    input's."""
    c_out, c_in, K, _ = w_shape
    R = c_in * K * K
    want = max(1 if c_out * R < 1 << 21 else 2, -(-R // MAX_CHUNK))
    if want > _tiles.MAX_SPLIT:
        raise ValueError(f"contraction R={R} too long for the conv kernel "
                         f"(at most {_tiles.MAX_SPLIT * MAX_CHUNK})")
    return _tiles.split_ranges(R, want, BK)


def conv_plan(x_shape, w_shape, stride: int = 1, dtype=torch.float32
              ) -> LaunchPlan:
    """How ``conv2d(x, w, stride)`` is launched: tile (pixels, channels),
    R-split, cluster, grid and shared memory.  (Both dtypes take the same
    plan.)"""
    N, _, h_in, w_in = x_shape
    c_out, _, K, _ = w_shape
    P = N * ((h_in - K) // stride + 1) * ((w_in - K) // stride + 1)
    splits = conv_splits(w_shape)

    def blocks(i):
        return -(-P // BM) * len(splits) * -(-c_out // CONV_TILES[i])
    # the narrowest width that holds every channel, else the widest; a grid
    # short of one block an SM takes the narrowest width whose grid still
    # fits on the card: a block's stages then take less time, and the sums
    # are the same (at VGG16's B = 1 pieces, 1.4x faster; an H100's timings)
    config = next((i for i in reversed(range(len(CONV_TILES)))
                   if CONV_TILES[i] >= c_out), 0)
    if blocks(config) < _tiles.N_SMS:
        config = max(i for i in range(config, len(CONV_TILES))
                     if i == config or blocks(i) <= _tiles.N_SMS)
    bn = CONV_TILES[config]
    grid = (-(-P // BM) * len(splits), -(-c_out // bn))
    # the ring, then one int offset of x per contraction row of a split
    smem = ring_bytes(bn) + 4 * (splits[0][1] - splits[0][0])
    return LaunchPlan("conv", config, (BM, bn), THREADS, splits, grid, smem,
                      smem,
                      _tiles.fill_note(grid[0] * grid[1],
                                       f"P={P} x C_O={c_out} in "
                                       f"{BM} x {bn} tiles, R split "
                                       f"{len(splits)} ways (at most "
                                       f"{_tiles.MAX_SPLIT})"))


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d")
    fn = lib.conv2d_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sw = lib.conv2d_split_w_launch
        sw.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        sw.restype = ctypes.c_int
    return lib


class _Split:
    """A weight's split for one tile: the tensor, the weight it was made
    from (weakly) and at which version, the event after its kernel, and
    the streams that may read it (each waited for the event once)."""

    __slots__ = ("ref", "version", "ws", "done", "streams")

    def __init__(self, ref, version, ws, done, stream):
        self.ref, self.version, self.ws, self.done = ref, version, ws, done
        self.streams = {stream}


def _make_split(w: torch.Tensor, config: int) -> torch.Tensor:
    """Launch the weight's split for tile ``config`` on the current
    stream, into a new tensor."""
    c_out, c_in, K, _ = w.shape
    ws = torch.empty(split_w_floats(w.shape, CONV_TILES[config]),
                     dtype=torch.float32, device=w.device)
    wc = w.contiguous()
    err = _lib().conv2d_split_w_launch(
        wc.data_ptr(), ws.data_ptr(), c_out, c_in, K, _DTYPES[w.dtype],
        config, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d weight split failed: CUDA error {err} "
                           f"(w {tuple(w.shape)}, {w.dtype}, tile {config})")
    with _count_lock:
        conv2d.weight_splits += 1
    return ws


def _drop(key, ref) -> None:
    with _splits_lock:
        e = _splits.get(key)
        if e is not None and e.ref is ref:
            del _splits[key]


def split_weight(w: torch.Tensor, config: int) -> torch.Tensor:
    """The split of ``w`` that the conv reads with tile ``config``, ready to
    be read on the current stream.

    Made once and kept while ``w`` lives and its version (in-place writes)
    is unchanged; then reused on any stream, which first waits for the
    split's kernel (once a stream) and is recorded on the split's memory,
    so that it is not reused while that stream may still read it.  While a
    CUDA graph is being captured the split is made afresh inside the graph
    and not kept: the graph then owns all it reads."""
    stream = torch.cuda.current_stream()
    try:
        version = w._version
    except RuntimeError:  # a tensor without a version counter
        version = None
    if version is None or torch.cuda.is_current_stream_capturing():
        return _make_split(w, config)
    key = (id(w), config)
    with _splits_lock:
        e = _splits.get(key)
        if e is not None and e.ref() is w and e.version == version:
            if stream not in e.streams:
                stream.wait_event(e.done)
                e.ws.record_stream(stream)
                e.streams.add(stream)
            return e.ws
        ws = _make_split(w, config)
        done = torch.cuda.Event()
        done.record(stream)
        _splits[key] = _Split(
            weakref.ref(w, lambda ref, key=key: _drop(key, ref)), version,
            ws, done, stream)
        return ws


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
    out = torch.empty((N, c_out, h_out, w_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        ws = split_weight(w, plan.config)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().conv2d_launch(
            x.data_ptr(), ws.data_ptr(), out.data_ptr(), N,
            c_in, c_out, h_out, w_out, K, stride, sn, sc, sh, sw,
            _DTYPES[x.dtype], plan.config, plan.cluster, plan.chunk,
            plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"conv2d launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"stride {stride}, {x.dtype}, {plan})")
    with _count_lock:
        conv2d.launches += 1
    return out


conv2d.launches = 0  # conv launches so far (not plain-version calls)
conv2d.weight_splits = 0  # weight splits made so far (split_weight)


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
