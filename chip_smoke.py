#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/``), and then, phase by phase, each printing JSON lines:

1. ``device``    — card name and power limit (``nvidia-smi``), torch and CUDA
                   versions, kernel build seconds.
2. ``kernels``   — every ported kernel against its plain PyTorch version on
                   the card, at the shapes the VGG16 and Zamba2 paths give
                   it and at the edge shapes (ragged F, C_O = 7, K in
                   {1, 5, 7}, stride 2, width slices, a ragged SSD chunk,
                   Mamba2-2.7B's SSD heads, bf16), with times, bounds and
                   the library yardstick (``torch.matmul`` / ``F.conv2d``,
                   TF32 off — timed here, never called by the port; the SSD
                   chunk has none).  The SSD cases are also held against an
                   f64 sequential scan.
3. ``coded_ops`` — ``coded_conv2d`` and ``coded_matmul`` through a
                   ``CodedExecutor`` with one dead worker and one straggler,
                   against the uncoded result.
4. ``vgg16``     — the main path: VGG16 at 224x224, f32, seeded random
                   weights, served through ``vgg16_forward`` on a worker pool
                   (requests of batch 1, 4, 1 on the virtual clock, two
                   more under torch.profiler, two on the real clock: the
                   first on fresh worker streams, the second on warm ones),
                   logits held against the
                   same network run uncoded through ``F.conv2d``; launch
                   counters prove the kernels carried the path.
5. ``zamba2``    — the second path: Zamba2-1.2B at full width (38 Mamba2
                   layers, d_model 2048, 64 SSD heads, the shared
                   attention + FFN block after every 6th layer), f32,
                   seeded random weights, served by ``Engine(coded=(10, 6),
                   executor=CodedExecutor(10, ...))`` with one dead worker
                   and a 50x straggler: 8 prompts of 512 tokens and 4 of
                   200, 16 new tokens each.  Prefill and per-step logits are
                   held against the same weights run uncoded, and the SSD
                   and skinny-GEMM launch counts against the design.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  There is no fallback: no GPU, a kernel
that does not build or launch, or any failed check ends the run with a
non-zero exit code and no result line.

``--phases kernels,zamba2`` runs a subset (for debugging; the result line is
only printed when every phase ran).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the roofline.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
L2_FLUSH_BYTES = 128 * 1024 * 1024  # > the 50 MB L2
SEED = 0
N_WORKERS = 10
ALL_PHASES = ("device", "kernels", "coded_ops", "vgg16", "zamba2")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Failed(RuntimeError):
    """A check of this script did not hold."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of one call: CUDA events around each of ``iters``
    calls, the L2 overwritten before each so that every call finds its
    inputs in device memory, as the bound assumes.  All calls are queued
    before the one synchronise, and the overwrites keep the device busy
    while the host queues, so the events see device time and not the
    host's launch latency."""

    def __init__(self, torch, warmup: int = 2, iters: int = 15):
        self.torch = torch
        self.warmup, self.iters = warmup, iters
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
        # bring an idle card up to its clocks before anything is timed
        a = torch.randn(4096, 4096, device="cuda")
        t_end = time.perf_counter() + 0.5
        while time.perf_counter() < t_end:
            for _ in range(10):
                a @ a
            torch.cuda.synchronize()
        # and the event and launch machinery of this process: one throwaway
        # measurement, so the first real case is timed like the rest
        self.ms(lambda: a @ a)

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(3):  # a head start for the host
            self.flush.zero_()
        for _ in range(self.iters):
            self.flush.zero_()
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]


def bound(n_bytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def phase_device(torch) -> dict:
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    info = _build.build_all()
    regs = {}
    for name, text in info["ptxas"].items():
        regs[name] = [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln][:24]
    out = {"phase": "device", "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "capability": list(torch.cuda.get_device_capability(0)),
           "build_seconds": round(info["seconds"], 3),
           "built": info["built"], "libs": info["libs"],
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "ptxas": regs}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(torch, gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32) * scale).to(dtype)


def gemm_cases(torch):
    """(name, A as numpy f64 or None for random, (m, b, F), dtype, headline)."""
    import numpy as np
    from repro_torch.core.coding import vandermonde_generator

    G106 = vandermonde_generator(10, 6)
    D66 = np.linalg.inv(G106[[0, 2, 3, 5, 7, 9]])
    D1616 = np.linalg.inv(vandermonde_generator(16, 16))
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        # VGG16 (224, n=10, k=6): encode at segment entry, decode at exit
        ("encode conv2_2 B=1", G106, 291840, f32, True),
        ("encode conv2_2 B=4", G106, 291840 * 4, f32, False),
        ("encode conv5_x B=1", G106, 32768, f32, False),
        ("decode conv2_2 B=1", D66, 128 * 112 * 18, f32, False),
        ("decode (6,6) F=32768", D66, 32768, f32, False),
        ("decode conv5_x B=4", D66, 4 * 512 * 14 * 2, f32, False),
        ("encode ragged F=4097", G106, 4097, f32, False),
        ("decode (16,16) F=4097", D1616, 4097, f32, False),
        ("decode (16,16) F=65536", D1616, 65536, f32, False),
        ("encode conv2_2 B=1 bf16", G106, 291840, bf16, False),
        ("encode ragged F=4097 bf16", G106, 4097, bf16, False),
        # the executor's piece GEMM: T=1030, k=6 -> t_p=171; d 1024 -> 4096
        ("piece GEMM 171x1024x4096", (171, 1024), 4096, f32, False),
        ("piece GEMM 171x1024x4096 bf16", (171, 1024), 4096, bf16, False),
        ("piece GEMM 37x48x80", (37, 48), 80, f32, False),
        # Zamba2-1.2B's coded FFN (n=10, k=6): prefill B=8, T=512 -> 4096
        # tokens, t_p = 682; prefill B=4, T=200 -> t_p = 133; decode B=8 ->
        # t_p = 1.  w_in / w_gate are 2048 -> 8192, w_out 8192 -> 2048.
        ("piece GEMM zamba2 prefill 682x2048x8192", (682, 2048), 8192, f32,
         False),
        ("piece GEMM zamba2 prefill 682x8192x2048", (682, 8192), 2048, f32,
         False),
        ("piece GEMM zamba2 prefill T=200 133x2048x8192", (133, 2048), 8192,
         f32, False),
        ("piece GEMM zamba2 decode 1x2048x8192", (1, 2048), 8192, f32, False),
        ("piece GEMM zamba2 decode 1x8192x2048", (1, 8192), 2048, f32, False),
        ("encode zamba2 prefill (10,6)@(6,682*2048)", G106, 682 * 2048, f32,
         False),
        ("encode zamba2 prefill w_out (10,6)@(6,682*8192)", G106, 682 * 8192,
         f32, False),
        ("decode zamba2 prefill (6,6)@(6,682*8192)", D66, 682 * 8192, f32,
         False),
        ("encode zamba2 decode (10,6)@(6,2048)", G106, 2048, f32, False),
        # the headline shape once more, last: two readings show the spread
        ("encode conv2_2 B=1 (again)", G106, 291840, f32, False),
    ]


def check_gemm(torch, timer, gen, name, A_src, F, dtype, headline) -> dict:
    from repro_torch.kernels.skinny_gemm import skinny_gemm, skinny_gemm_plain

    if isinstance(A_src, tuple):
        m, b = A_src
        A = _rand(torch, gen, (m, b), dtype, b ** -0.5)
    else:
        m, b = A_src.shape
        A = torch.from_numpy(A_src.copy()).to(dtype).cuda()
    X = _rand(torch, gen, (b, F), dtype)
    got = skinny_gemm(A, X)
    torch.cuda.synchronize()
    want = skinny_gemm_plain(A, X)
    require(got.shape == (m, F) and got.dtype == dtype, f"{name}: shape/dtype")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    # tolerance scales with |A| @ |X|: two f32 summation orders differ by at
    # most ~2 b u S (u = 2^-24); a bf16 result adds one rounding of 2^-8 each
    S = A.float().abs() @ X.float().abs()
    coef = 2.0 * (b + 2) * 2.0 ** -24 + (2.0 ** -7 if dtype == torch.bfloat16
                                         else 0.0)
    err = (got.float() - want.float()).abs()
    ratio = float((err / (coef * S + 1e-30)).max())
    require(ratio <= 1.0, f"{name}: kernel differs from plain version, "
                          f"err/tol = {ratio:.3g}")
    # an independent f64 product of the same (rounded) inputs: shows the
    # comparison above is not vacuous when kernel and library agree exactly
    exact = A.double() @ X.double()
    err64 = (got.double() - exact).abs()
    ratio64 = float((err64 / (coef * S.double() + 1e-30)).max())
    require(ratio64 <= 1.0, f"{name}: kernel differs from the f64 product, "
                            f"err/tol = {ratio64:.3g}")
    # same reduction order whatever block of F an element falls in
    if F >= 64:
        c0, c1 = F // 3 + 1, 2 * F // 3 + 3
        part = skinny_gemm(A, X[:, c0:c1].contiguous())
        require(bool(torch.equal(part, got[:, c0:c1])),
                f"{name}: a column block is not bit-identical to the whole")
    item = X.element_size()
    n_bytes = (m * b + b * F + m * F) * item
    dn = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(n_bytes, 2.0 * m * b * F, dn)
    return {"case": name, "kernel": "skinny_gemm", "shape": [m, b, F],
            "dtype": dn, "headline": headline,
            "max_abs_err": float(err.max()), "tol_coef": coef,
            "err_over_tol": ratio, "max_abs_err_vs_f64": float(err64.max()),
            "ms": timer.ms(lambda: skinny_gemm(A, X)),
            "plain_ms": timer.ms(lambda: skinny_gemm_plain(A, X)),
            "library_ms": timer.ms(lambda: torch.matmul(A, X)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_cases(torch):
    """(name, x shape, slice of W or None, w shape, stride, dtype, headline)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        # VGG16 (224, n=10, k=6) worker pieces, remainders and local layers
        ("conv2_2 piece B=1", (1, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, True),
        ("conv2_2 piece B=4", (4, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, False),
        ("conv2_2 10 pieces folded", (10, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, False),
        ("conv2_2 remainder slice", (1, 128, 114, 114), (108, 114), (128, 128, 3, 3), 1, f32, False),
        ("conv3_2 piece B=1", (1, 256, 58, 11), None, (256, 256, 3, 3), 1, f32, False),
        ("conv4_2 piece B=1", (1, 512, 30, 6), None, (512, 512, 3, 3), 1, f32, False),
        ("conv5_x piece B=1", (1, 512, 16, 4), None, (512, 512, 3, 3), 1, f32, False),
        ("conv5_x piece B=4", (4, 512, 16, 4), None, (512, 512, 3, 3), 1, f32, False),
        ("conv1_1 local B=1", (1, 3, 226, 226), None, (64, 3, 3, 3), 1, f32, False),
        ("conv1_2 local B=4", (4, 64, 226, 226), None, (64, 64, 3, 3), 1, f32, False),
        # edges
        ("C_O=7 K=5 stride 2", (1, 8, 11, 17), None, (7, 8, 5, 5), 2, f32, False),
        ("K=1", (1, 4, 9, 9), None, (64, 4, 1, 1), 1, f32, False),
        ("stride 2", (1, 32, 8, 30), None, (16, 32, 3, 3), 2, f32, False),
        ("K=7 stride 2 (ResNet stem)", (2, 3, 70, 70), None, (64, 3, 7, 7), 2, f32, False),
        ("conv2_2 piece B=1 bf16", (1, 128, 114, 20), None, (128, 128, 3, 3), 1, bf16, False),
        ("conv5_x piece B=4 bf16", (4, 512, 16, 4), None, (512, 512, 3, 3), 1, bf16, False),
        ("C_O=7 K=5 stride 2 bf16", (1, 8, 11, 17), None, (7, 8, 5, 5), 2, bf16, False),
    ]


def check_conv(torch, timer, gen, name, xs, sl, ws, stride, dtype,
               headline) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain

    x = _rand(torch, gen, xs, dtype, 0.5)
    if sl is not None:
        x = x[..., sl[0]:sl[1]]  # a width slice, read in place
    c_out, c_in, K, _ = ws
    w = _rand(torch, gen, ws, dtype, (c_in * K * K) ** -0.5)
    got = conv2d(x, w, stride)
    torch.cuda.synchronize()
    want = conv2d_plain(x, w, stride)
    require(got.shape == want.shape and got.dtype == dtype,
            f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    R = c_in * K * K
    S = F.conv2d(x.float().abs(), w.float().abs(), stride=stride)
    coef = 2.0 * (R + 2) * 2.0 ** -24 + (2.0 ** -7 if dtype == torch.bfloat16
                                         else 0.0)
    err = (got.float() - want.float()).abs()
    ratio = float((err / (coef * S + 1e-30)).max())
    require(ratio <= 1.0, f"{name}: kernel differs from plain version, "
                          f"err/tol = {ratio:.3g}")
    # an independent f64 convolution of the same (rounded) inputs
    exact = F.conv2d(x.double(), w.double(), stride=stride)
    err64 = (got.double() - exact).abs()
    ratio64 = float((err64 / (coef * S.double() + 1e-30)).max())
    require(ratio64 <= 1.0, f"{name}: kernel differs from the f64 "
                            f"convolution, err/tol = {ratio64:.3g}")
    item = x.element_size()
    n_bytes = (x.numel() + w.numel() + got.numel()) * item
    dn = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(n_bytes, 2.0 * got.numel() * R, dn)
    return {"case": name, "kernel": "conv2d", "shape": [list(x.shape),
                                                        list(ws), stride],
            "dtype": dn, "headline": headline,
            "max_abs_err": float(err.max()), "tol_coef": coef,
            "err_over_tol": ratio, "max_abs_err_vs_f64": float(err64.max()),
            "ms": timer.ms(lambda: conv2d(x, w, stride)),
            "plain_ms": timer.ms(lambda: conv2d_plain(x, w, stride)),
            "library_ms": timer.ms(lambda: F.conv2d(x, w, stride=stride)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def ssd_cases(torch):
    """(name, B, T, H, P, N, chunk, h0, dtype, entry, headline); entry
    "scan" is one launch for the whole sequence (``ssd_chunk_scan``, what
    ``models.ssm.ssd_chunked`` calls), "chunk" the Pallas signature."""
    f32, bf16 = torch.float32, torch.bfloat16
    z = (64, 64, 64)  # Zamba2-1.2B: H = 2 * 2048 / 64, P = 64, N = 64
    return [
        ("zamba2 prefill B=8 T=512", 8, 512, *z, 128, False, f32, "scan",
         True),
        ("zamba2 prefill B=8 T=512, h0", 8, 512, *z, 128, True, f32, "scan",
         False),
        ("zamba2 prefill B=1 T=512", 1, 512, *z, 128, False, f32, "scan",
         False),
        ("zamba2 prefill B=4 T=200 (ragged chunk)", 4, 200, *z, 128, False,
         f32, "scan", False),
        # Mamba2-2.7B: H = 2 * 2560 / 64 = 80, N = 128
        ("mamba2-2.7b heads B=2 T=512", 2, 512, 80, 64, 128, 128, False, f32,
         "scan", False),
        ("zamba2 prefill B=8 T=512 bf16 x", 8, 512, *z, 128, False, bf16,
         "scan", False),
        ("one chunk L=128, h0", 8, 128, *z, 128, True, f32, "chunk", False),
        ("one chunk L=72, h0", 2, 72, *z, 72, True, f32, "chunk", False),
    ]


def ssd_inputs(torch, gen, B, T, H, P, N, h0, dtype):
    """Inputs distributed as a Mamba2 layer makes them: x, Bm, Cm ~ N(0, 1)
    (post-conv activations), dt = softplus(N(0, 1) + dt_bias) with the
    init's dt_bias, A = -linspace(1, 16, H) (the init's A_log)."""
    import torch.nn.functional as F

    x = _rand(torch, gen, (B, T, H, P), dtype)
    raw = torch.randn((B, T, H), generator=gen, device="cuda")
    dt = F.softplus(raw + math.log(math.expm1(1e-2)))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = _rand(torch, gen, (B, T, N), dtype)
    Cm = _rand(torch, gen, (B, T, N), dtype)
    h = _rand(torch, gen, (B, H, P, N), torch.float32) if h0 else None
    return x, dt, A, Bm, Cm, h


def ssd_f64_scan(torch, x, dt, A, Bm, Cm, h0):
    """The sequential-scan oracle ``ssd_chunk_ref`` in f64, lane by lane."""
    from repro_torch.kernels.ref import ssd_chunk_ref

    B, T, H, P = x.shape
    N = Bm.shape[-1]
    ys, hs = [], []
    for b in range(B):
        h = (torch.zeros((H, P, N), dtype=torch.float64, device=x.device)
             if h0 is None else h0[b].double())
        y, h = ssd_chunk_ref(x[b].double(), dt[b].double(), A.double(),
                             Bm[b].double(), Cm[b].double(), h)
        ys.append(y)
        hs.append(h)
    return torch.stack(ys), torch.stack(hs)


def ssd_work(B, T, H, P, N, chunk) -> float:
    """FLOPs the chunked dual form needs: per (batch, chunk) the causal
    half of C B^T once (shared by the heads), per head the causal half of
    the weighted product with x, the incoming-state and the outgoing-state
    products — over the rows the sequence has (a ragged last chunk counts
    its own rows, not the padding)."""
    macs = 0
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        tri = n * (n + 1) // 2
        macs += tri * N + H * (tri * P + 2 * n * N * P)
    return 2.0 * B * macs


def ssd_compare(torch, name, inputs, chunk, refs: dict, got) -> tuple:
    """Hold an SSD result ``got = (y, h)`` against each reference in
    ``refs`` and fail beyond tolerance.  Returns (errors, err/tol ratios,
    y's tolerance coefficient, max |cum dA|).

    Tolerance: every term of y and of the state is a product of magnitudes
    summed over N (C.B), the chunk (s <= l) and, for the incoming state, N
    again; the same function of |x|, |Bm|, |Cm|, |h0| bounds the sum of
    magnitudes.  f32 sums of that length differ by a few (N + L) u of it,
    and exp(cum_l - cum_s) by |cum| u, where |cum| is the largest running
    sum of dA inside a chunk; a bf16 y adds one rounding (2^-8) per side.
    """
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_plain

    x, dt, A, Bm, Cm, h = inputs
    B, T, H, _ = x.shape
    N = Bm.shape[-1]
    absh = h.abs() if h is not None else None
    Sy, Sh = ssd_chunk_scan_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), absh,
                                  chunk)
    c = -(-T // chunk)
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, c * chunk - T))
    max_cum = float(dA.reshape(B, c, chunk, H).cumsum(2).abs().max())
    coef = 4.0 * (N + chunk + max_cum) * 2.0 ** -24
    coef_y = coef + (2.0 ** -7 if x.dtype == torch.bfloat16 else 0.0)
    errs, ratios = {}, {}
    for ref_name, (ry, rh) in refs.items():
        for part, a, b, S, k in (("y", got[0], ry, Sy, coef_y),
                                 ("h", got[1], rh, Sh, coef)):
            key = f"{part} vs {ref_name}"
            e = (a.double() - b.double()).abs()
            errs[key] = e
            ratios[key] = float((e / (k * S.double() + 1e-30)).max())
            require(ratios[key] <= 1.0, f"{name}: {key} err/tol = "
                                        f"{ratios[key]:.3g}")
    return errs, ratios, coef_y, max_cum


def check_ssd(torch, timer, gen, name, B, T, H, P, N, chunk, h0, dtype,
              entry, headline) -> dict:
    from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_scan,
                                               ssd_chunk_scan_plain)

    x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, h0, dtype)
    if entry == "chunk":
        require(T == chunk, f"{name}: one chunk means T == chunk")
        h = h if h is not None else torch.zeros((B, H, P, N), device="cuda")
        run = lambda: ssd_chunk(x, dt, A, Bm, Cm, h)
    else:
        run = lambda: ssd_chunk_scan(x, dt, A, Bm, Cm, h, chunk)
    plain = lambda: ssd_chunk_scan_plain(x, dt, A, Bm, Cm, h, chunk)
    y, hT = run()
    torch.cuda.synchronize()
    py, ph = plain()
    require(tuple(y.shape) == (B, T, H, P) and y.dtype == dtype
            and tuple(hT.shape) == (B, H, P, N) and hT.dtype == torch.float32,
            f"{name}: shapes/dtypes")
    require(bool(torch.isfinite(y.float()).all())
            and bool(torch.isfinite(hT).all()), f"{name}: non-finite")
    fy, fh = ssd_f64_scan(torch, x, dt, A, Bm, Cm, h)
    errs, ratios, coef_y, max_cum = ssd_compare(
        torch, name, (x, dt, A, Bm, Cm, h), chunk,
        {"plain": (py, ph), "f64 scan": (fy, fh)}, (y, hT))
    flops = ssd_work(B, T, H, P, N, chunk)
    item = x.element_size()
    n_bytes = ((x.numel() + Bm.numel() + Cm.numel() + y.numel()) * item
               + (dt.numel() + A.numel() + hT.numel()
                  + (h.numel() if h is not None else 0)) * 4)
    dn = str(dtype).replace("torch.", "")
    # the kernel computes in f32 whatever x's type: bound by the f32 rate
    bound_ms, bound_by = bound(n_bytes, flops, "float32")
    return {"case": name, "kernel": "ssd_chunk",
            "shape": {"B": B, "T": T, "H": H, "P": P, "N": N, "chunk": chunk,
                      "h0": h0, "entry": entry},
            "dtype": dn, "headline": headline,
            "max_abs_err": float(errs["y vs plain"].max()),
            "errors": {k: float(e.max()) for k, e in errs.items()},
            "err_over_tol": max(ratios.values()), "ratios": ratios,
            "tol_coef": coef_y, "max_cum": max_cum,
            "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
            "ms": timer.ms(run), "plain_ms": timer.ms(plain),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(torch) -> list[dict]:
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [check_gemm(torch, timer, gen, *c) for c in gemm_cases(torch)]
    cases += [check_conv(torch, timer, gen, *c) for c in conv_cases(torch)]
    cases += [check_ssd(torch, timer, gen, *c) for c in ssd_cases(torch)]
    emit({"phase": "kernels", "timing": "median of 15 calls, CUDA events, "
          "L2 overwritten before each call, TF32 off", "cases": cases})
    return cases


# ---------------------------------------------------------------------------
# phase 3: coded ops on the worker pool
# ---------------------------------------------------------------------------

def make_executor(clock):
    from repro_torch.dist import (CodedExecutor, DeterministicDelay, FakeClock,
                                  FaultPlan)

    faults = FaultPlan(dead=frozenset({1}), straggler={2: 50.0})
    if isinstance(clock, FakeClock):
        return CodedExecutor(N_WORKERS, clock=clock,
                             delay_model=DeterministicDelay(1.0),
                             fault_plan=faults)
    return CodedExecutor(N_WORKERS, clock=clock, fault_plan=faults)


def phase_coded_ops(torch) -> None:
    from repro_torch.core import (ConvSpec, MDSScheme, ReplicationScheme,
                                  coded_conv2d, coded_matmul, conv2d)
    from repro_torch.dist import FakeClock
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    spec = ConvSpec(c_in=512, c_out=512, h_in=30, w_in=30, kernel=3, stride=1)
    x = _rand(torch, gen, (1, 512, 30, 30), torch.float32, 0.5)
    w = _rand(torch, gen, (512, 512, 3, 3), torch.float32, (512 * 9) ** -0.5)
    xm = _rand(torch, gen, (1030, 1024), torch.float32)
    wm = _rand(torch, gen, (1024, 4096), torch.float32, 1024 ** -0.5)
    y_conv = conv2d(x, w, 1)
    y_mm = xm @ wm
    rows = []
    for code in (MDSScheme.make(N_WORKERS, 6), ReplicationScheme.make(N_WORKERS)):
        ex = make_executor(FakeClock())
        try:
            got_c = coded_conv2d(x, w, code, spec, executor=ex)
            rep_c = ex.last_report
            got_m = coded_matmul(xm, wm, code, executor=ex)
            rep_m = ex.last_report
            torch.cuda.synchronize()
        finally:
            ex.close()
        for op, got, want, rep, R in (
                ("conv2d conv4_2", got_c, y_conv, rep_c, 512 * 9),
                ("matmul 1030x1024x4096", got_m, y_mm, rep_m, 1024)):
            # coded vs uncoded: the pieces carry the f32 roundoff of a
            # length-R sum (~sqrt(R) u, u = 2^-24) and the decode amplifies
            # it by |D|_inf |G_S|_inf for the subset that arrived; selection
            # schemes decode by gather (amplification 1)
            amp = 1.0
            if hasattr(code, "decode_matrix"):
                D = np.abs(code.decode_matrix(rep.subset)).sum(1).max()
                G = np.abs(code.generator[rep.subset]).sum(1).max()
                amp = float(D * G)
            tol = amp * R ** 0.5 * 2.0 ** -24 * float(want.abs().max())
            err = float((got - want).abs().max())
            require(got.shape == want.shape, f"{op}: shape")
            require(err <= tol, f"coded {op} under {code}: err {err} > {tol}")
            rows.append({"op": op, "scheme": code.scheme_name, "n": code.n,
                         "k": code.k, "max_abs_err": err, "tol": tol,
                         "decode_amplification": amp,
                         "subset": rep.subset, "redispatched": rep.redispatched,
                         "failures": rep.failures,
                         "t_complete": rep.t_complete})
    emit({"phase": "coded_ops", "faults": "dead={1}, straggler={2: 50x}",
          "clock": "FakeClock + DeterministicDelay(1.0)", "ops": rows})


# ---------------------------------------------------------------------------
# phase 4: the main path — VGG16 served on the worker pool
# ---------------------------------------------------------------------------

def vgg16_uncoded_plain(torch, layers, params, x):
    """The same network with no coding and no port code on the arithmetic:
    F.conv2d (TF32 off), relu, max-pool, head."""
    import torch.nn.functional as F

    h = x
    for li, w in zip(layers, params["convs"]):
        h = F.conv2d(F.pad(h, (li.pad,) * 4), w, stride=li.spec.stride)
        if li.act is not None:
            require(li.act == "relu", "VGG16 has relu only")
            h = F.relu(h)
        if li.pool:
            h = F.max_pool2d(h, li.pool, li.pool)
    return h.reshape(h.shape[0], -1) @ params["head"]


def device_time_of(prof) -> dict:
    """Sum of device time and the top kernels from a torch.profiler run.
    Only rows that are device kernels count: an operator row repeats the
    time of the kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t:
            rows.append((float(t), ev.key, int(ev.count)))
    if not rows:
        raise RuntimeError("no device kernel rows in the profile")
    rows.sort(reverse=True)
    host = sorted(((float(ev.self_cpu_time_total), ev.key, int(ev.count))
                   for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) != DeviceType.CUDA),
                  reverse=True)
    return {"device_ms": sum(r[0] for r in rows) / 1e3,
            "top": [{"name": k[:60], "ms": t / 1e3, "calls": c}
                    for t, k, c in rows[:6]],
            "host_ops_ms": sum(r[0] for r in host) / 1e3,
            "host_top": [{"name": k[:60], "ms": t / 1e3, "calls": c}
                         for t, k, c in host[:6]]}


def t_compute_stats(values: list[float]) -> dict:
    """Median, p90, max and sum in ms of real-clock piece compute times
    (each from the piece's launch to its own stream's synchronise)."""
    v = sorted(values)
    if not v:
        return {"pieces": 0}
    return {"pieces": len(v), "median": v[len(v) // 2] * 1e3,
            "p90": v[int(0.9 * (len(v) - 1))] * 1e3, "max": v[-1] * 1e3,
            "sum": sum(v) * 1e3}


def phase_vgg16(torch) -> dict:
    from repro_torch.core import SystemParams, compile_plan
    from repro_torch.core.coded_conv import boundary_op_counter
    from repro_torch.core.netplan import SegmentStep
    from repro_torch.dist import FakeClock, RealClock
    from repro_torch.kernels.conv2d import conv2d as conv_kernel
    from repro_torch.kernels.skinny_gemm import skinny_gemm
    from repro_torch.models.cnn import (init_vgg16, vgg16_conv_specs,
                                        vgg16_forward)

    image, n_classes = 224, 1000
    layers = vgg16_conv_specs(image)
    plan = compile_plan(layers, N_WORKERS, SystemParams(), "mds")
    segs = [s for s in plan.steps if isinstance(s, SegmentStep)]
    n_local = sum(s.stop - s.start for s in plan.steps
                  if not isinstance(s, SegmentStep))
    require(all(s.stop - s.start == 1 for s in segs), "depth-1 segments")
    # per request, with worker 1 dead and absorbed by the code's redundancy:
    # every local layer, and per segment the n - 1 live pieces (on the
    # virtual clock every live worker computes its piece) + the remainder
    conv_per_req = n_local + sum(
        (N_WORKERS - 1) + (1 if s.split.remainder is not None else 0)
        for s in segs)
    gemm_per_req = 2 * len(segs)

    params = init_vgg16(torch.Generator(device="cuda").manual_seed(SEED),
                        n_classes=n_classes, image=image)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batches = {b: torch.randn((b, 3, image, image), generator=gen,
                              device="cuda") for b in (1, 4)}
    want = {b: vgg16_uncoded_plain(torch, layers, params, xb)
            for b, xb in batches.items()}
    torch.cuda.synchronize()

    # ---- the counted run starts here --------------------------------------
    skinny_gemm.launches = 0
    conv_kernel.launches = 0
    requests = []

    def serve(ex, xb, label, *, exact_counts, profile=False):
        g0, c0 = skinny_gemm.launches, conv_kernel.launches
        prof, prof_out = None, None
        if profile:
            try:
                from torch.profiler import ProfilerActivity, profile as tprof
                prof = tprof(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
                prof.__enter__()
            except Exception as e:  # a measurement aid, not a check
                prof, prof_out = None, f"profiler unavailable: {e!r}"
        reports = []
        ex.on_report = reports.append
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with boundary_op_counter() as ops:
            logits = vgg16_forward(params, xb, plan=plan, executor=ex)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ex.on_report = None
        if prof is not None:
            prof.__exit__(None, None, None)
            try:
                prof_out = device_time_of(prof)
                prof_out["idle_share"] = max(
                    0.0, 1.0 - prof_out["device_ms"] / wall_ms)
            except Exception as e:
                prof_out = f"profiler gave no device times: {e!r}"
        b = xb.shape[0]
        ref = want[b]
        require(tuple(logits.shape) == (b, n_classes), f"{label}: shape")
        require(bool(torch.isfinite(logits).all()), f"{label}: non-finite")
        # coded (hand kernels, 10 MDS decodes) vs uncoded (F.conv2d): f32
        # roundoff through 13 layers, amplified by each decode matrix
        tol = 1e-3 * float(ref.abs().max())
        err = float((logits - ref).abs().max())
        require(err <= tol, f"{label}: logits differ, {err} > {tol}")
        require(bool((logits.argmax(-1) == ref.argmax(-1)).all()),
                f"{label}: argmax differs from the uncoded run")
        require(ops == {"encode": len(segs), "decode": len(segs)},
                f"{label}: boundary ops {ops}")
        dg = skinny_gemm.launches - g0
        dc = conv_kernel.launches - c0
        require(dg == gemm_per_req, f"{label}: {dg} skinny-GEMM launches, "
                                    f"plan implies {gemm_per_req}")
        if exact_counts:
            require(dc == conv_per_req, f"{label}: {dc} conv launches, plan "
                                        f"implies {conv_per_req}")
        else:  # real clock: cancelled stragglers may drop their pieces
            k_min = n_local + sum(
                s.scheme.k + (1 if s.split.remainder is not None else 0)
                for s in segs)
            require(k_min <= dc <= conv_per_req + len(segs),
                    f"{label}: {dc} conv launches outside "
                    f"[{k_min}, {conv_per_req + len(segs)}]")
        rep = ex.last_report
        requests.append({
            "request": label, "batch": b, "wall_ms": wall_ms,
            "max_abs_err": err, "tol": tol,
            "max_abs_logit": float(ref.abs().max()),
            "argmax_equal": True, "boundary_ops": ops,
            "skinny_gemm_launches": dg, "conv2d_launches": dc,
            "last_segment": {"t_complete": rep.t_complete,
                             "subset": rep.subset,
                             "redispatched": rep.redispatched,
                             "failures": rep.failures},
            "piece_t_compute_ms": None if exact_counts else t_compute_stats(
                [t.t_compute for r in reports for t in r.timings]),
            "profile": prof_out})

    ex = make_executor(FakeClock())
    try:
        serve(ex, batches[1], "virtual clock, batch 1 (first)", exact_counts=True)
        serve(ex, batches[4], "virtual clock, batch 4", exact_counts=True)
        serve(ex, batches[1], "virtual clock, batch 1", exact_counts=True)
        serve(ex, batches[1], "virtual clock, batch 1, profiled",
              exact_counts=True, profile=True)
        serve(ex, batches[4], "virtual clock, batch 4, profiled",
              exact_counts=True, profile=True)
        dispatches = ex.pool.dispatch_count
        runs = ex.run_count
    finally:
        ex.close()
    ex = make_executor(RealClock())
    try:
        serve(ex, batches[1], "real clock, batch 1", exact_counts=False)
        serve(ex, batches[1], "real clock, batch 1, warm", exact_counts=False)
    finally:
        ex.close()
    torch.cuda.synchronize()
    counts = {"skinny_gemm": skinny_gemm.launches,
              "conv2d": conv_kernel.launches}
    # ---- the counted run ends here ----------------------------------------
    require(counts["skinny_gemm"] > 0 and counts["conv2d"] > 0,
            f"a kernel of the path was never launched: {counts}")
    emit({"phase": "vgg16", "model": "VGG16 13-conv stack, 224x224, f32, "
          f"{n_classes} classes, seeded random weights",
          "plan": plan.describe(), "workers": N_WORKERS,
          "faults": "dead={1}, straggler={2: 50x}",
          "reference": "same weights, uncoded, F.conv2d with TF32 off",
          "per_request": {"skinny_gemm_launches": gemm_per_req,
                          "conv2d_launches_virtual_clock": conv_per_req,
                          "boundary_ops": 2 * len(segs)},
          "virtual_clock_runs": runs, "virtual_clock_dispatches": dispatches,
          "launches": counts, "requests": requests})
    return counts


# ---------------------------------------------------------------------------
# phase 5: the second path — Zamba2-1.2B served on the worker pool
# ---------------------------------------------------------------------------

ZAMBA2_BUCKETS = ((8, 512, 16), (4, 200, 16))  # requests, prompt, new tokens
ZAMBA2_K = 6


def zamba2_expected(cfg, n_live: int) -> dict:
    """Launches and coded runs the design implies for the two buckets.

    SSD: one ``ssd_chunk_scan`` launch per Mamba2 layer per prefill (the
    chunk loop runs inside the kernel); decode steps run the recurrence in
    plain torch.  Coded GEMMs: each of the shared block's calls runs 3 FFN
    GEMMs, coded when the step has >= k tokens (a B=4 decode step has 4 <
    6: master-local); each coded run launches the skinny GEMM for the
    encode, for each live worker's piece (on the virtual clock every live
    worker computes its piece, the straggler too) and for the decode.
    """
    shared = sum(cfg.has_shared_attn(i) for i in range(cfg.n_layers))
    runs = 0
    for n_req, T, new in ZAMBA2_BUCKETS:
        steps = int(n_req * T >= ZAMBA2_K) + (new - 1) * int(n_req >= ZAMBA2_K)
        runs += 3 * shared * steps
    return {"coded_runs": runs, "ssd_chunk": cfg.n_layers * len(ZAMBA2_BUCKETS),
            "skinny_gemm": runs * (1 + n_live + 1)}


def phase_zamba2(torch) -> dict:
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.dist import FakeClock
    from repro_torch.kernels.skinny_gemm import skinny_gemm
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_scan_plain
    from repro_torch.models import model as M
    from repro_torch.models.common import rms_norm
    from repro_torch.models.ssm import (_causal_conv, _split_in_proj,
                                        ssd_chunked)
    from repro_torch.serving import Engine, Request

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype=torch.float32)
    dims = cfg.ssm_dims
    require((cfg.n_layers, cfg.d_model, dims.n_heads) == (38, 2048, 64),
            "zamba2-1.2b at full width")
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 3))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 4)
    reqs, buckets = [], []
    for n_req, T, new in ZAMBA2_BUCKETS:
        ids = list(range(len(reqs), len(reqs) + n_req))
        reqs += [Request(i, rng.integers(0, cfg.vocab, T, dtype=np.int32),
                         max_new=new) for i in ids]
        buckets.append((ids, T, new))
    n_tokens = sum(r.max_new for r in reqs)

    ex = make_executor(FakeClock())
    live = N_WORKERS - len(ex.pool.fault_plan.dead)
    want_counts = zamba2_expected(cfg, live)
    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, ZAMBA2_K), executor=ex)
        # the counted run's per-step logits, recorded as the engine makes
        # them (the check below holds them against the uncoded model)
        steps = []

        def recording(fn):
            def wrapped(*args):
                logits, cache = fn(*args)
                steps.append(logits[:, 0, : cfg.vocab])
                return logits, cache
            return wrapped

        eng._prefill, eng._decode = (recording(eng._prefill),
                                     recording(eng._decode))
        reports = []
        ex.on_report = reports.append
        torch.cuda.synchronize()

        # ---- the counted run starts here ----------------------------------
        skinny_gemm.launches = 0
        ssd_chunk.launches = 0
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"skinny_gemm": skinny_gemm.launches,
                  "ssd_chunk": ssd_chunk.launches}
        # ---- the counted run ends here ------------------------------------
        ex.on_report = None
        eng._bind_steps()
        runs, dispatches = ex.run_count, ex.pool.dispatch_count
        require(counts["ssd_chunk"] > 0 and counts["skinny_gemm"] > 0,
                f"a kernel of the path was never launched: {counts}")
        require(counts["ssd_chunk"] == want_counts["ssd_chunk"],
                f"{counts['ssd_chunk']} SSD launches, the design implies "
                f"{want_counts['ssd_chunk']}")
        require(counts["skinny_gemm"] == want_counts["skinny_gemm"],
                f"{counts['skinny_gemm']} skinny-GEMM launches, the design "
                f"implies {want_counts['skinny_gemm']}")
        require(runs == len(reports) == want_counts["coded_runs"],
                f"{runs} coded runs ({len(reports)} reports), the design "
                f"implies {want_counts['coded_runs']}")
        for r in reports:
            require(r.t_complete == 1.0 and 1 not in r.subset
                    and 2 not in r.subset,
                    f"a coded run waited or used a faulty worker: "
                    f"t_complete {r.t_complete}, subset {r.subset}")

        # ---- the profiled run: the same requests --------------------------
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            again = eng.generate(reqs)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        profile = device_time_of(prof)
        profile["wall_ms"] = prof_wall_ms
        profile["idle_share"] = max(0.0, 1.0 - profile["device_ms"]
                                    / prof_wall_ms)
        require(all(np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(out, again)),
                "two coded runs of the same requests gave other tokens")
    finally:
        ex.close()

    # ---- coded vs uncoded, teacher-forced on the coded tokens ------------
    by_id = {c.rid: c for c in out}
    worst, near_ties, checked, i = 0.0, 0, 0, 0
    for ids, T, new in buckets:
        toks = torch.as_tensor(np.stack([reqs[j].prompt for j in ids]),
                               device="cuda")
        gen = np.stack([by_id[j].tokens for j in ids])  # (b, new)
        logits, cache = M.prefill(cfg, params, toks, max_seq=T + new)
        for s in range(new):
            if s:
                nxt = torch.as_tensor(gen[:, s - 1: s], device="cuda")
                logits, cache = M.decode_step(cfg, params, cache, token=nxt)
            ref = logits[:, 0, : cfg.vocab]
            got = steps[i]
            i += 1
            tol = 1e-3 * float(ref.abs().max())
            err = float((got - ref).abs().max())
            require(err <= tol, f"zamba2 bucket T={T} step {s}: coded "
                                f"logits differ by {err} > {tol}")
            worst = max(worst, err / tol)
            require(bool((got.argmax(-1).cpu().numpy() == gen[:, s]).all()),
                    "served tokens are not the argmax of their logits")
            top2 = ref.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            agree = ref.argmax(-1).cpu().numpy() == gen[:, s]
            require(bool(agree[margin > tol].all()),
                    f"zamba2 bucket T={T} step {s}: a token differs from "
                    "the uncoded one outside a near-tie")
            near_ties += int((margin <= tol).sum())
            checked += int((margin > tol).sum())
    require(i == len(steps), f"{len(steps)} recorded steps, {i} checked")

    # ---- one prefill layer's SSD: the kernel and the plain chunk function
    x = params["embed"][torch.as_tensor(
        np.stack([reqs[j].prompt for j in buckets[0][0]]), device="cuda")]
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype, device="cuda")
    mp = params["layers"][0]["mamba"]
    _, xbc, dt_raw = _split_in_proj(
        rms_norm(x, params["layers"][0]["norm"]) @ mp["in_proj"], dims)
    xbc = F.silu(_causal_conv(xbc, mp["conv_w"], mp["conv_b"]))
    di, N = dims.d_inner, dims.d_state
    xs = xbc[..., :di].reshape(x.shape[0], x.shape[1], dims.n_heads,
                               dims.head_dim)
    Bm, Cm = xbc[..., di: di + N], xbc[..., di + N:]
    dt = F.softplus(dt_raw.float() + mp["dt_bias"])
    A = -torch.exp(mp["A_log"])
    n0 = ssd_chunk.launches
    yk, hk = ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    torch.cuda.synchronize()
    require(ssd_chunk.launches == n0 + 1, "ssd_chunked did not launch "
                                          "the kernel once")
    yp, hp = ssd_chunk_scan_plain(xs, dt, A, Bm, Cm, None, cfg.ssm_chunk)
    errs, ratios, _, max_cum = ssd_compare(
        torch, "zamba2 layer 0 SSD", (xs, dt, A, Bm, Cm, None),
        cfg.ssm_chunk, {"plain": (yp, hp)}, (yk, hk))

    def event_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    layer_ssd = {
        "shape": list(xs.shape), "N": N, "chunk": cfg.ssm_chunk,
        "max_cum": max_cum,
        "kernel_ms": event_ms(lambda: ssd_chunked(xs, dt, A, Bm, Cm,
                                                  chunk=cfg.ssm_chunk)),
        "plain_ms": event_ms(lambda: ssd_chunk_scan_plain(
            xs, dt, A, Bm, Cm, None, cfg.ssm_chunk)),
        "max_abs_diff": {k: float(e.max()) for k, e in errs.items()},
        "err_over_tol": ratios,
        "max_abs_y": float(yp.abs().max())}

    ttft, own, per_tok, prev_end = {}, {}, {}, 0.0
    for ids, T, new in buckets:
        first = max(by_id[j].first_token_s for j in ids)
        last = max(by_id[j].latency_s for j in ids)
        ttft[T] = first * 1e3
        own[T] = (first - prev_end) * 1e3
        per_tok[T] = (last - first) / max(new - 1, 1) * 1e3
        prev_end = last
    emit({"phase": "zamba2",
          "model": "zamba2-1.2b, 38 Mamba2 layers, d_model 2048, 64 SSD "
                   "heads, shared attention+FFN after 6 of them, f32, "
                   "seeded random weights",
          "params": M.param_count(params), "init_s": init_s,
          "coded": {"scheme": "mds", "n": N_WORKERS, "k": ZAMBA2_K,
                    "workers": N_WORKERS,
                    "faults": "dead={1}, straggler={2: 50x}",
                    "clock": "FakeClock + DeterministicDelay(1.0)"},
          "buckets": [{"requests": len(ids), "prompt": T, "max_new": new}
                      for ids, T, new in buckets],
          "reference": "same weights, uncoded Engine model functions, "
                       "teacher-forced on the served tokens",
          "wall_s": wall_s, "tokens": n_tokens,
          "tokens_per_s": n_tokens / wall_s,
          "ttft_ms": ttft, "ttft_own_bucket_ms": own,
          "decode_ms_per_token": per_tok,
          "coded_runs": runs, "dispatches": dispatches,
          "launches": counts, "launches_expected": want_counts,
          "t_complete": sorted({r.t_complete for r in reports}),
          "steps_checked": len(steps), "tokens_checked": checked,
          "near_ties": near_ties, "worst_logit_err_over_tol": worst,
          "layer0_ssd": layer_ssd, "profile": profile})
    return counts


# ---------------------------------------------------------------------------

KERNEL_META = {
    "skinny_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/skinny_gemm.cu",
        "replaces": "src/repro/kernels/mds_encode.py:57"},
    "conv2d": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d.py:67"},
    "ssd_chunk": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:66"},
}


def kernels_line(cases: list[dict], by_path: dict) -> dict:
    """One entry per kernel: ``launches`` sums the main paths' counted runs
    (``launches_by_path`` splits them), the numbers are the headline case's,
    ``max_abs_err`` the worst over its cases in the headline's type."""
    out = []
    for name, meta in KERNEL_META.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["headline"])
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        out.append({
            "name": name, **meta, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "shape": head["case"], "dtype": head["dtype"],
            "max_abs_err": max(c["max_abs_err"] for c in mine
                               if c["dtype"] == head["dtype"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "cases_checked": len(mine),
            "worst_err_over_tol": max(c["err_over_tol"] for c in mine)})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    # the yardsticks and the plain versions run in full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    device = phase_device(torch) if "device" in phases else None
    cases = phase_kernels(torch) if "kernels" in phases else None
    if "coded_ops" in phases:
        phase_coded_ops(torch)
    by_path = {}
    if "vgg16" in phases:
        by_path["vgg16"] = phase_vgg16(torch)
    if "zamba2" in phases:
        by_path["zamba2"] = phase_zamba2(torch)

    if set(phases) != set(ALL_PHASES):
        print(f"partial run ({phases}): no result line", file=sys.stderr)
        return 0
    emit(kernels_line(cases, by_path))
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
