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

What bounds it on an H100: the multiply-add rate (per chunk one L x L x N
product shared by the heads, per head three of L x P x N, causal L x L x P
and P x L x N).

What the design does about it (``csrc/ssd_chunk.cu``): a sequence runs as
four passes in the chunk-parallel form of the reference's
``models/ssm.py::ssd_chunked``, each a kernel with its plain PyTorch version
here:

    ssd_cb          G = tril(C B^T) once per (batch, chunk), shared by heads
    ssd_states      S = sum_s (w_s x_s)^T B_s per (batch, chunk, head),
                    w_s = exp(cum_end - cum_s) dt_s, and cum_end
    ssd_state_pass  the states entering each chunk (sequential over chunks,
                    parallel over batch, head and the P x N state) and the
                    final state
    ssd_out         y = (G o exp(segsum) o dt) x + diag(exp(cum)) C Hin^T

Only the state pass walks the chunks in order.  The products run on the
tensor cores as 3xTF32 (hi / lo split of each operand, f32 accuracy), bf16
x / Bm / Cm are upcast on load, y is written in x's dtype and states in
f32.  Limits: chunk <= 128, head dim <= 64, state <= 128.  :func:`ssd_plan`
gives each pass's grid and shared memory.

:func:`ssd_chunk_plain` is a transcription of ``_ssd_kernel`` batched over
B; :func:`ssd_chunk_scan_plain` runs it chunk by chunk with the reference
``ssd_chunked``'s zero padding of a ragged last chunk.  On a CPU tensor
:func:`ssd_chunk` and :func:`ssd_chunk_scan` compute those, and each pass
wrapper its own plain version.  On a CUDA tensor they launch the kernels or
raise.  :func:`ssd_chunk_scan_passes_plain` composes the passes' plain
versions.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from . import _build
from ._tiles import SMEM_LIMIT

__all__ = ["ssd_chunk", "ssd_chunk_scan", "ssd_chunk_plain",
           "ssd_chunk_scan_plain", "ssd_cb", "ssd_states", "ssd_state_pass",
           "ssd_out", "ssd_cb_plain", "ssd_states_plain",
           "ssd_state_pass_plain", "ssd_out_plain",
           "ssd_chunk_scan_passes_plain", "ssd_plan", "PassPlan", "PASSES",
           "LMAX", "PMAX", "NMAX"]

LMAX, PMAX, NMAX = 128, 64, 128  # the kernels' chunk, head-dim, state limits
PASSES = ("cb", "states", "state_pass", "out")
THREADS, WIDE = 128, 256  # threads of the cb pass, of the other three
RB = 64   # rows of a C B^T tile
KS, STAGES = 32, 3  # out: slab width of the contraction, ring depth
SM_SHARED = 233_472  # shared memory of one H100 SM; each block reserves 1 KB
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_X, _VEC_B, _VEC_C, _VEC_G, _VEC_S = 1, 2, 4, 8, 16
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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


def _wide(t):
    """f32, or f64 for f64 input (the passes' plain versions then serve as
    their own f64 oracle)."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


def _chunked(t, L: int):
    """(B, T, ...) -> (B, c, L, ...) in f32 (f64 kept), the tail of a
    ragged last chunk zero: the reference's padding."""
    T = t.shape[1]
    c = -(-T // L)
    t = _wide(t)
    if c * L != T:
        z = torch.zeros((t.shape[0], c * L - T) + tuple(t.shape[2:]),
                        dtype=t.dtype, device=t.device)
        t = torch.cat([t, z], dim=1)
    return t.reshape((t.shape[0], c, L) + tuple(t.shape[2:]))


def _cum(dt, A, L: int):
    """Running sum of dA inside each chunk: (B, c, L, H)."""
    return torch.cumsum(_chunked(dt, L) * _wide(A), dim=2)


def ssd_cb_plain(Bm, Cm, chunk: int):
    """Pass 1: G[b, c] = tril(C_c B_c^T), (B, c, L, L), for Bm / Cm
    (B, T, N) in chunks of ``chunk`` rows."""
    Bc, Cc = _chunked(Bm, chunk), _chunked(Cm, chunk)
    return torch.einsum("bcln,bcsn->bcls", Cc, Bc).tril()


def ssd_states_plain(x, dt, A, Bm, chunk: int):
    """Pass 2: each chunk's own state S (B, c, H, P, N) = sum_s B_s
    exp(cum_end - cum_s) dt_s x_s, and cum_end (B, c, H)."""
    xc, dtc, Bc = _chunked(x, chunk), _chunked(dt, chunk), _chunked(Bm, chunk)
    cum = _cum(dt, A, chunk)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)
    S = torch.einsum("bcsn,bcsh,bcsh,bcshp->bchpn", Bc, decay_to_end, dtc, xc)
    return S, cum[:, :, -1]


def ssd_state_pass_plain(S, cum_end, h0=None):
    """Pass 3: the state entering each chunk, Hin (B, c, H, P, N), and the
    final state (B, H, P, N): Hin[0] = h0 (zeros when None), Hin[c + 1] =
    Hin[c] exp(cum_end[c]) + S[c]."""
    h = (torch.zeros_like(S[:, 0]) if h0 is None
         else h0.to(S.dtype))
    Hin = torch.empty_like(S)
    for j in range(S.shape[1]):
        Hin[:, j] = h
        h = h * torch.exp(cum_end[:, j])[:, :, None, None] + S[:, j]
    return Hin, h


def ssd_out_plain(x, dt, A, Cm, G, Hin, chunk: int):
    """Pass 4: y (B, T, H, P) in x's dtype from the causal C B^T ``G``
    (B, c, L, L) and the entering states ``Hin`` (B, c, H, P, N)."""
    Bsz, T, H, P = x.shape
    L = chunk
    xc, dtc, Cc = _chunked(x, L), _chunked(dt, L), _chunked(Cm, L)
    cum = _cum(dt, A, L)                                  # (B, c, L, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, c, l, s, H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                     float("-inf")))
    y_intra = torch.einsum("bclsh,bcls,bcsh,bcshp->bclhp", Lmat, _wide(G),
                           dtc, xc)
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(cum),
                           _wide(Hin))
    y = (y_intra + y_inter).reshape(Bsz, -1, H, P)[:, :T]
    return y if x.dtype == torch.float64 else y.to(x.dtype)


def ssd_chunk_scan_passes_plain(x, dt, A, Bm, Cm, h0=None, chunk: int = 128):
    """The four passes' plain versions composed: the same function as
    :func:`ssd_chunk_scan_plain`, computed the way the kernels cut it."""
    G = ssd_cb_plain(Bm, Cm, chunk)
    S, cum_end = ssd_states_plain(x, dt, A, Bm, chunk)
    Hin, hT = ssd_state_pass_plain(S, cum_end, h0)
    return ssd_out_plain(x, dt, A, Cm, G, Hin, chunk), hT


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _stride_a(n: int) -> int:  # = 4 mod 8: conflict-free A fragments
    return _up(n, 8) + 4


def _stride_b(n: int) -> int:  # = 8 mod 16: conflict-free B fragments
    return _up(n, 16) + 8


@dataclass(frozen=True)
class PassPlan:
    """One pass's launch: grid (x, y, z), threads per block, dynamic
    shared memory in bytes."""

    grid: tuple
    threads: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def blocks_per_sm(self) -> int:
        """Resident blocks per SM as shared memory and the SM's 2048
        threads allow (at most 16)."""
        return min(16, 2048 // self.threads,
                   SM_SHARED // (self.smem + 1024))


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, T: int, H: int, P: int, N: int, L: int) -> dict:
    """How each pass of a (B, T, H, P, N) sequence in chunks of ``L`` is
    launched; ``csrc/ssd_chunk.cu`` holds the same shared-memory formulas
    and rejects any other."""
    if not (1 <= L <= LMAX and 1 <= P <= PMAX and 1 <= N <= NMAX):
        raise ValueError(
            f"SSD kernel limits: chunk <= {LMAX}, head dim <= {PMAX}, state "
            f"<= {NMAX}; got chunk={L}, P={P}, N={N}")
    c, lk, nt, sa = -(-T // L), _up(L, 8), -(-L // RB), _stride_a(KS)
    plans = {
        "cb": PassPlan((nt * nt, c, B), THREADS, 4 * 2 * RB * _stride_a(N)),
        "states": PassPlan((H, c, B), WIDE,
                           4 * (lk * _stride_b(P) + lk * _stride_b(N)
                                + 3 * LMAX)),
        "state_pass": PassPlan((-(-P * N // WIDE), H, B), WIDE, 0),
        "out": PassPlan((H, c, B), WIDE,
                        4 * (STAGES * (lk * sa + max(_up(P, 8) * sa,
                                                     KS * _stride_b(P)))
                             + 2 * LMAX)),
    }
    assert all(p.smem <= SMEM_LIMIT for p in plans.values())
    if B > 65535 or c > 65535 or H > 65535:
        raise ValueError(f"batch {B}, chunks {c} or heads {H} out of range "
                         "for the kernels' grids")
    return plans


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    if not lib.ssd_out_launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_cb_launch.argtypes = [P, P, P, P, I, I, P]
        lib.ssd_states_launch.argtypes = [P] * 7 + [I, I, P]
        lib.ssd_state_pass_launch.argtypes = [P] * 7
        lib.ssd_out_launch.argtypes = [P] * 8 + [I, I, P]
        for fn in (lib.ssd_cb_launch, lib.ssd_states_launch,
                   lib.ssd_state_pass_launch, lib.ssd_out_launch):
            fn.restype = ctypes.c_int
    return lib


def _aligned(t, n: int, *strides) -> bool:
    """Rows of ``t`` start on 4-element boundaries (16 bytes in f32, 8 in
    bf16) and hold a multiple of 4 elements: the kernels copy them by
    quads."""
    return (t.data_ptr() % (4 * t.element_size()) == 0 and n % 4 == 0
            and all(s % 4 == 0 for s in strides))


class _Seq:
    """One sequence's operands in the kernels' form: x, Bm, Cm in one type
    (f32 or bf16) with unit innermost stride, dt and A f32, and the
    ``dims`` array the C entry points read."""

    def __init__(self, x, dt, A, Bm, Cm, chunk: int):
        Bsz, T, H, P = x.shape
        N = Bm.shape[-1]
        self.out_dtype = x.dtype
        if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
            x, Bm, Cm = x.float(), Bm.float(), Cm.float()
        x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (x, Bm, Cm))
        self.x, self.Bm, self.Cm = x, Bm, Cm
        self.dt = dt.to(torch.float32)
        self.A = A.to(torch.float32).contiguous()
        self.shape = (Bsz, T, H, P, N, chunk)
        self.plan = ssd_plan(Bsz, T, H, P, N, chunk)
        self.c = -(-T // chunk)
        vec = ((_VEC_X if _aligned(x, P, *x.stride()[:3]) else 0)
               | (_VEC_B if _aligned(Bm, N, *Bm.stride()[:2]) else 0)
               | (_VEC_C if _aligned(Cm, N, *Cm.stride()[:2]) else 0)
               | (_VEC_G if chunk % 4 == 0 else 0)
               | (_VEC_S if N % 4 == 0 else 0))
        vals = [Bsz, T, H, P, N, chunk, self.c, *x.stride()[:3],
                *self.dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2], vec]
        self.dims = (ctypes.c_longlong * len(vals))(*vals)
        self.dtype = _DTYPES[x.dtype]
        self.device = x.device
        self.stream = torch.cuda.current_stream(x.device).cuda_stream
        self.lib = _lib()

    def empty(self, *shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.device)


def _raise_on(err: int, what: str, seq: _Seq) -> None:
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk {what} launch failed: CUDA error {err} (B, T, H, P, "
            f"N, chunk = {seq.shape}, {seq.x.dtype})")


def _count(name: str) -> None:
    with _count_lock:
        ssd_chunk.pass_launches[name] += 1


def _run_cb(seq: _Seq):
    Bsz, T, H, P, N, L = seq.shape
    G = seq.empty(Bsz, seq.c, L, L)
    err = seq.lib.ssd_cb_launch(
        seq.Bm.data_ptr(), seq.Cm.data_ptr(), G.data_ptr(), seq.dims,
        seq.dtype, seq.plan["cb"].smem, seq.stream)
    _raise_on(err, "cb", seq)
    _count("cb")
    return G


def _run_states(seq: _Seq):
    Bsz, T, H, P, N, L = seq.shape
    S = seq.empty(Bsz, seq.c, H, P, N)
    cum_end = seq.empty(Bsz, seq.c, H)
    err = seq.lib.ssd_states_launch(
        seq.x.data_ptr(), seq.dt.data_ptr(), seq.A.data_ptr(),
        seq.Bm.data_ptr(), S.data_ptr(), cum_end.data_ptr(), seq.dims,
        seq.dtype, seq.plan["states"].smem, seq.stream)
    _raise_on(err, "states", seq)
    _count("states")
    return S, cum_end


def _run_state_pass(seq: _Seq, S, cum_end, h0):
    Bsz, T, H, P, N, L = seq.shape
    S, cum_end = S.contiguous(), cum_end.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    Hin = torch.empty_like(S)
    hT = seq.empty(Bsz, H, P, N)
    err = seq.lib.ssd_state_pass_launch(
        S.data_ptr(), cum_end.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        Hin.data_ptr(), hT.data_ptr(), seq.dims, seq.stream)
    _raise_on(err, "state_pass", seq)
    _count("state_pass")
    return Hin, hT


def _run_out(seq: _Seq, G, Hin):
    Bsz, T, H, P, N, L = seq.shape
    G, Hin = G.contiguous(), Hin.contiguous()
    y = seq.empty(Bsz, T, H, P, dtype=seq.x.dtype)
    err = seq.lib.ssd_out_launch(
        seq.x.data_ptr(), seq.dt.data_ptr(), seq.A.data_ptr(),
        seq.Cm.data_ptr(), G.data_ptr(), Hin.data_ptr(), y.data_ptr(),
        seq.dims, seq.dtype, seq.plan["out"].smem, seq.stream)
    _raise_on(err, "out", seq)
    _count("out")
    return y.to(seq.out_dtype)


def _launch(x, dt, A, Bm, Cm, h0, chunk: int):
    """The four passes on the card: one ``ssd_chunk`` launch."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with torch.cuda.device(x.device):
        seq = _Seq(x, dt, A, Bm, Cm, chunk)
        G = _run_cb(seq)
        S, cum_end = _run_states(seq)
        Hin, hT = _run_state_pass(seq, S, cum_end, h0)
        y = _run_out(seq, G, Hin)
    with _count_lock:
        ssd_chunk.launches += 1
    return y, hT


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

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


def _chunk_arg(chunk) -> int:
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return chunk


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
    (B, T, H, P) in x's dtype, final state (B, H, P, N) f32).  One
    ``ssd_chunk`` launch (the four passes) on a CUDA tensor."""
    _check(x, dt, A, Bm, Cm, h0)
    chunk = _chunk_arg(chunk)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, dt, A, Bm, Cm, h0, chunk)
    return _launch(x, dt, A, Bm, Cm, h0, chunk)


def _pass_seq(x, dt, A, Bm, Cm, chunk, *more):
    """The operands of one pass, checked like the whole scan's (a pass
    that does not read x or Bm is given a stand-in of the right shape);
    ``more`` are the pass's other tensors, which must lie on x's device."""
    _check(x, dt, A, Bm, Cm, None)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t is not None and t.device != x.device for t in more):
        raise ValueError(f"SSD pass operands on several devices: "
                         f"{[t.device for t in more if t is not None]}, "
                         f"{x.device}")
    return _Seq(x, dt, A, Bm, Cm, _chunk_arg(chunk))


def ssd_cb(Bm, Cm, chunk: int):
    """Pass 1 (see :func:`ssd_cb_plain`): G (B, c, L, L) f32."""
    chunk = _chunk_arg(chunk)
    if Bm.device.type == "cpu":
        return ssd_cb_plain(Bm, Cm, chunk)
    Bsz, T, N = Bm.shape
    x = Bm.new_empty((Bsz, T, 1, 1))
    dt = torch.empty((Bsz, T, 1), device=Bm.device)
    with torch.cuda.device(Bm.device):
        seq = _pass_seq(x, dt, torch.empty(1, device=Bm.device), Bm, Cm,
                        chunk)
        return _run_cb(seq)


def ssd_states(x, dt, A, Bm, chunk: int):
    """Pass 2 (see :func:`ssd_states_plain`): (S (B, c, H, P, N) f32,
    cum_end (B, c, H) f32)."""
    chunk = _chunk_arg(chunk)
    if x.device.type == "cpu":
        return ssd_states_plain(x, dt, A, Bm, chunk)
    with torch.cuda.device(x.device):
        return _run_states(_pass_seq(x, dt, A, Bm, Bm, chunk))


def ssd_state_pass(S, cum_end, h0=None):
    """Pass 3 (see :func:`ssd_state_pass_plain`): (Hin (B, c, H, P, N),
    final state (B, H, P, N)), both f32."""
    if S.device.type == "cpu":
        return ssd_state_pass_plain(S, cum_end, h0)
    Bsz, c, H, P, N = S.shape
    if tuple(cum_end.shape) != (Bsz, c, H) or (
            h0 is not None and tuple(h0.shape) != (Bsz, H, P, N)):
        raise ValueError(f"S {tuple(S.shape)}, cum_end "
                         f"{tuple(cum_end.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    # a sequence of c chunks of one step each has the same state layout
    x = S.new_empty((Bsz, c, H, P))
    dt = S.new_empty((Bsz, c, H))
    Bm = S.new_empty((Bsz, c, N))
    with torch.cuda.device(S.device):
        seq = _pass_seq(x, dt, S.new_empty(H), Bm, Bm, 1, cum_end, h0)
        return _run_state_pass(seq, S.to(torch.float32), cum_end, h0)


def ssd_out(x, dt, A, Cm, G, Hin, chunk: int):
    """Pass 4 (see :func:`ssd_out_plain`): y (B, T, H, P) in x's dtype."""
    chunk = _chunk_arg(chunk)
    if x.device.type == "cpu":
        return ssd_out_plain(x, dt, A, Cm, G, Hin, chunk)
    with torch.cuda.device(x.device):
        seq = _pass_seq(x, dt, A, Cm, Cm, chunk, G, Hin)
        Bsz, T, H, P, N, L = seq.shape
        if tuple(G.shape) != (Bsz, seq.c, L, L) or \
                tuple(Hin.shape) != (Bsz, seq.c, H, P, N):
            raise ValueError(f"G {tuple(G.shape)}, Hin {tuple(Hin.shape)} "
                             f"for (B, c, L, H, P, N) = "
                             f"{(Bsz, seq.c, L, H, P, N)}")
        return _run_out(seq, G.to(torch.float32), Hin.to(torch.float32))


ssd_chunk.launches = 0  # ssd_chunk / ssd_chunk_scan calls run on the card
# kernel launches of each pass (every call above launches all four; the pass
# wrappers launch one); plain-version calls count nowhere
ssd_chunk.pass_launches = dict.fromkeys(PASSES, 0)
