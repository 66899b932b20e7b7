"""Mamba2 SSD chunk: the intra-chunk dual form plus the chunk's state
hand-over, for one chunk (:func:`ssd_chunk`) or a whole sequence of chunks
(:func:`ssd_chunk_scan`).

Source note
-----------
Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_chunk_pallas`` (body ``_ssd_kernel``, helper ``_segsum``), wrapped in
the reference by ``kernels/ops.py::ssd_chunk``.  With ``dA = dt * A`` and
``cum`` its running sum inside the chunk::

    y  = intra(exp(segsum(dA)) * C B^T, dt, x) + C exp(cum) h0
    h1 = h0 exp(sum dA) + sum_s B_s exp(cum_end - cum_s) dt_s x_s

What bounds it on an H100: the f32 multiply-add rate (three small matrix
products per head and chunk: L x L x N, L x L x P and L x P x N).

What the design does about it (``csrc/ssd_chunk.cu``): the TPU kernel's grid
is the batch with a whole chunk (every head) resident, 2 MB at Zamba2's
widths — far over a Hopper block's 227 KB of shared memory.  The CUDA grid
is (head, batch); a block holds one head's chunk and state in shared memory
and walks the chunks of the sequence in order, carrying the state, so a
Mamba2 layer's whole prefill is ONE launch.  All arithmetic is f32 ``fmaf``
(no TF32), the causal mask is explicit, bf16 x / Bm / Cm are upcast on load,
y is written in x's dtype and the state in f32.  Limits: chunk <= 128,
head dim <= 64, state <= 128.

:func:`ssd_chunk_plain` is a transcription of ``_ssd_kernel`` batched over
B; :func:`ssd_chunk_scan_plain` runs it chunk by chunk with the reference
``ssd_chunked``'s zero padding of a ragged last chunk.  On a CPU tensor the
wrappers compute those.  On a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["ssd_chunk", "ssd_chunk_scan", "ssd_chunk_plain",
           "ssd_chunk_scan_plain", "LMAX", "PMAX", "NMAX"]

LMAX, PMAX, NMAX = 128, 64, 128  # the kernel's chunk, head-dim, state limits
_SMEM_MAX = 232448  # bytes of shared memory one Hopper block can opt into
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def ssd_chunk_plain(x, dt, A, Bm, Cm, h0):
    """Plain PyTorch version of one chunk, the reference's ``_ssd_kernel``
    with a batch axis: x (B, L, H, P), dt (B, L, H), A (H,), Bm / Cm
    (B, L, N), h0 (B, H, P, N) -> (y in x's dtype, h1 in f32)."""
    f32 = torch.float32
    x_, dt_, A_, B_, C_, h_ = (t.to(f32) for t in (x, dt, A, Bm, Cm, h0))
    L = x.shape[1]
    dA = dt_ * A_[None, None, :]                          # (B, L, H)
    cum = torch.cumsum(dA, dim=1)                         # (B, L, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]         # (B, l, s, H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                     float("-inf")))
    CB = torch.einsum("bln,bsn->bls", C_, B_)             # (B, L, L)
    y_intra = torch.einsum("blsh,bls,bsh,bshp->blhp", Lmat, CB, dt_, x_)
    y_inter = torch.einsum("bln,blh,bhpn->blhp", C_, torch.exp(cum), h_)
    y = (y_intra + y_inter).to(x.dtype)
    decay_to_end = torch.exp(cum[:, -1:] - cum)           # (B, L, H)
    S = torch.einsum("bln,blh,blh,blhp->bhpn", B_, decay_to_end, dt_, x_)
    h1 = h_ * torch.exp(cum[:, -1])[:, :, None, None] + S
    return y, h1


def ssd_chunk_scan_plain(x, dt, A, Bm, Cm, h0=None, chunk: int = 128):
    """Plain PyTorch version of the whole sequence: x (B, T, H, P), dt
    (B, T, H), Bm / Cm (B, T, N), h0 (B, H, P, N) or None (zeros), chunks
    of ``chunk`` steps; a ragged last chunk is padded with dt = 0 steps, as
    the reference ``ssd_chunked`` pads.  -> (y (B, T, H, P) in x's dtype,
    final state (B, H, P, N) f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(t0 + chunk, T))
        pad = chunk - (sl.stop - sl.start)
        xc, dc, bc, cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        if pad:
            def zpad(t):
                z = torch.zeros((Bsz, pad) + tuple(t.shape[2:]),
                                dtype=t.dtype, device=t.device)
                return torch.cat([t, z], dim=1)
            xc, dc, bc, cc = zpad(xc), zpad(dc), zpad(bc), zpad(cc)
        yc, h = ssd_chunk_plain(xc, dc, A, bc, cc, h)
        ys.append(yc[:, : chunk - pad])
    return torch.cat(ys, dim=1), h


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk_scan_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x, dt, A, Bm, Cm, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.dim() != 3:
        raise ValueError(
            f"need x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (Bsz, T, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (Bsz, T, N) or tuple(Cm.shape) != (Bsz, T, N):
        raise ValueError(
            f"mismatched SSD operands: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}")
    if h0 is not None and tuple(h0.shape) != (Bsz, H, P, N):
        raise ValueError(f"h0 must be {(Bsz, H, P, N)}, got {tuple(h0.shape)}")
    if x.numel() == 0 or Bm.numel() == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    devs = {t.device for t in (x, dt, A, Bm, Cm)
            } | ({h0.device} if h0 is not None else set())
    if len(devs) != 1:
        raise ValueError(f"SSD operands on several devices: {devs}")


def _launch(x, dt, A, Bm, Cm, h0, chunk: int):
    """Launch the scan kernel over chunks of ``chunk`` steps (CUDA only)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (1 <= chunk <= LMAX and P <= PMAX and N <= NMAX):
        raise ValueError(
            f"SSD kernel limits: chunk <= {LMAX}, head dim <= {PMAX}, state "
            f"<= {NMAX}; got chunk={chunk}, P={P}, N={N}")
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} out of range for the kernel")
    # x, Bm and Cm share one element type in the kernel; mixed types are
    # all read as f32, which loses nothing
    out_dtype = x.dtype
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    if x.stride(-1) != 1:
        x = x.contiguous()
    if Bm.stride(-1) != 1:
        Bm = Bm.contiguous()
    if Cm.stride(-1) != 1:
        Cm = Cm.contiguous()
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    lib = _lib()
    if lib.ssd_chunk_smem_bytes(chunk, P, N) > _SMEM_MAX:
        raise ValueError(f"chunk={chunk}, P={P}, N={N} needs more shared "
                         "memory than a Hopper block has")
    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_chunk_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), Bsz, T, H, P, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, N={N}, chunk={chunk}, "
                           f"{x.dtype})")
    with _count_lock:
        ssd_chunk.launches += 1
    return y.to(out_dtype), h_out


def ssd_chunk(x, dt, A, Bm, Cm, h0):
    """One SSD chunk with the Pallas kernel's signature: x (B, L, H, P),
    dt (B, L, H), A (H,), Bm / Cm (B, L, N), h0 (B, H, P, N) -> (y
    (B, L, H, P) in x's dtype, h1 (B, H, P, N) f32)."""
    _check(x, dt, A, Bm, Cm, h0)
    if h0 is None:
        raise ValueError("ssd_chunk needs h0 (B, H, P, N)")
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, Bm, Cm, h0)
    return _launch(x, dt, A, Bm, Cm, h0, x.shape[1])


def ssd_chunk_scan(x, dt, A, Bm, Cm, h0=None, chunk: int = 128):
    """The whole sequence in chunks of ``chunk`` steps: x (B, T, H, P), dt
    (B, T, H), Bm / Cm (B, T, N), h0 (B, H, P, N) or None (zeros) -> (y
    (B, T, H, P) in x's dtype, final state (B, H, P, N) f32).  One kernel
    launch for the whole sequence on a CUDA tensor."""
    _check(x, dt, A, Bm, Cm, h0)
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, dt, A, Bm, Cm, h0, chunk)
    return _launch(x, dt, A, Bm, Cm, h0, chunk)


ssd_chunk.launches = 0  # kernel launches so far (not plain-version calls)
