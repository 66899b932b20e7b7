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
                   it (every VGG16 piece at B = 1 and 4, remainders, local
                   layers; every Zamba2 piece GEMM) and at the edge shapes
                   (the GEMV regime at t_p 1-16 and its edge t_p = 17, a
                   ragged contraction, ragged and unaligned F, C_O = 7, K
                   in {1, 5, 7}, stride 2, width slices, a ragged SSD chunk,
                   Mamba2-2.7B's SSD heads, SSD widths that are no multiple
                   of 4, bf16), with times, bounds and the library
                   yardstick (``torch.matmul`` / ``F.conv2d``, TF32 off —
                   timed here, never called by the port; the SSD chunk has
                   none).  Every case is also held against an f64 product
                   (the SSD: an f64 sequential scan and the composition of
                   its passes' plain versions), and each of the SSD's four
                   passes alone against its plain version and f64 at the
                   headline shape.  Bit for bit: a column block of every
                   GEMM and a row block of every tiled GEMM equal the same
                   part of the whole, a split-K GEMM or conv run twice is
                   the same, every SSD case and pass run twice is the same,
                   10 conv pieces stacked into one launch equal the 10
                   launches of one, and the stacked piece GEMM
                   (``piece_gemm_stacked``, 10 pieces of t_p in {1, 2, 16,
                   17, 133, 682} rows at both Zamba2 weight shapes) equals
                   its 10 single launches, timed beside them.  Every coding
                   case (the encodes and decodes of both models, the ragged
                   and unaligned edges of the variants) also runs each
                   coding variant that can take it, on the whole and on a
                   column block, bit for bit the chosen variant's, and is
                   timed beside a device copy of the same bytes.
3. ``coded_ops`` — ``coded_conv2d`` and ``coded_matmul`` through a
                   ``CodedExecutor`` with one dead worker and one straggler,
                   against the uncoded result; the same ops on a
                   ``MeshExecutor`` with the same faults, bit for bit equal
                   to the pool's, a graph replay equal to the eager program,
                   and every scheme x fault x op at small shapes.
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
                   (and each of its passes) and skinny-GEMM launch counts
                   against the design.
6. ``zamba2_mesh`` — the same requests on the same weights served by
                   ``Engine(coded=(10, 6), executor=MeshExecutor(dead=(1,),
                   stragglers=(2,)))``: every coded GEMM one CUDA graph
                   replay (encode, the 10 pieces in one stacked launch,
                   decode).  Tokens equal the ``zamba2`` phase's, logits
                   are held against its uncoded ones; programs, graphs and
                   launches against the design; runtime calls
                   (``cudaStreamSynchronize`` fewer than the pool's), device
                   time, idle share, TTFT and ms/token beside the pool's.
7. ``adaptive``  — the adaptive loop on the card: (a) the same requests and
                   weights served by ``Engine(coded=(10, 6), executor=
                   <the zamba2 pool>, adaptive=True)``, every coded GEMM
                   re-planning (k, assignment) from the live worker
                   profiles; logits against the uncoded model, the 50x
                   straggler starved of pieces, every skinny-GEMM launch
                   by (regime, variant, shape) against the design of the
                   (n, k) each GEMM ran at, a second run making the same
                   plans; static against adaptive.  (b) VGG16 on an
                   ``AdaptiveExecutor`` whose worker 4 drifts to an 8x
                   straggler: every request right, the breach explainer
                   ranks worker 4 first, the regime detector dates the
                   drift, and the re-planned network is right too.  (c) an
                   ``Autoscaler`` over an elastic pool: pinned decisions, n
                   following the fleet, the coded decode-step GEMM against
                   f64 after every step.  (d) the ``zamba2_mesh`` executor
                   with a trace sink: one real-clock run span per coded op,
                   their sum beside each ``generate``'s wall.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  There is no fallback: no GPU, a kernel
that does not build or launch, or any failed check ends the run with a
non-zero exit code and no result line.

``--phases kernels,zamba2`` runs a subset (for debugging; the result line is
only printed when every phase ran; ``zamba2_mesh`` and ``adaptive`` need
``zamba2``).  ``--time-kernels CHECKOUT`` only times
the skinny GEMM, the conv and the SSD scan of the port in another checkout
(a parent commit unpacked beside this one) at this script's f32 cases, so
that two versions can be held against each other in one run on one card.
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
L2_FLUSH_BYTES = 128 * 1024 * 1024  # > the 50 MB L2
SEED = 0
N_WORKERS = 10
ALL_PHASES = ("device", "kernels", "coded_ops", "vgg16", "zamba2",
              "zamba2_mesh", "adaptive")


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
        # a head start for the host: ~2.5 ms of device work queued before
        # the first timed call, so that a wrapper whose host side takes
        # longer than its kernels is still timed on the device
        for _ in range(64):
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
    """(name, A as numpy f64 or (m, b) for random, F, dtype, headline[,
    unaligned]): unaligned puts X 4 bytes past its allocation."""
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
        ("piece GEMM zamba2 prefill T=200 w_out 133x8192x2048", (133, 8192),
         2048, f32, False),
        ("piece GEMM zamba2 decode 1x2048x8192", (1, 2048), 8192, f32, False),
        ("piece GEMM zamba2 decode 1x8192x2048", (1, 8192), 2048, f32, False),
        # the GEMV regime (t_p <= 16) at other t_p, its edge, a ragged
        # contraction (no multiple of any split), ragged and unaligned F
        # (X starts 4 bytes past an allocation), bf16
        ("piece GEMV 2x2048x8192", (2, 2048), 8192, f32, False),
        ("piece GEMV 6x2048x8192", (6, 2048), 8192, f32, False),
        ("piece GEMV 16x2048x8192", (16, 2048), 8192, f32, False),
        ("piece GEMV 2x8192x2048", (2, 8192), 2048, f32, False),
        ("piece GEMV 6x8192x2048", (6, 8192), 2048, f32, False),
        ("piece GEMV 16x8192x2048", (16, 8192), 2048, f32, False),
        ("piece GEMM regime edge 17x8192x2048", (17, 8192), 2048, f32, False),
        ("piece GEMV ragged b 1x8191x2048", (1, 8191), 2048, f32, False),
        ("piece GEMM ragged b 133x8191x2048", (133, 8191), 2048, f32, False),
        ("piece GEMV unaligned X 3x2048x8191", (3, 2048), 8191, f32, False,
         True),
        ("piece GEMM unaligned X 40x2048x4097", (40, 2048), 4097, f32, False,
         True),
        ("piece GEMV 1x8192x2048 bf16", (1, 8192), 2048, bf16, False),
        ("piece GEMV unaligned X 6x2048x8191 bf16", (6, 2048), 8191, bf16,
         False, True),
        ("piece GEMM 133x2048x8192 bf16", (133, 2048), 8192, bf16, False),
        ("encode zamba2 prefill (10,6)@(6,682*2048)", G106, 682 * 2048, f32,
         False),
        ("encode zamba2 prefill w_out (10,6)@(6,682*8192)", G106, 682 * 8192,
         f32, False),
        ("decode zamba2 prefill (6,6)@(6,682*8192)", D66, 682 * 8192, f32,
         False),
        ("encode zamba2 decode (10,6)@(6,2048)", G106, 2048, f32, False),
        # the rest of Zamba2's coding shapes: the decode step's (t_p = 1:
        # F = 2048 and 8192), prefill bucket 1's decode into w_out's input,
        # and bucket 2's (t_p = 133)
        ("encode zamba2 decode (10,6)@(6,8192)", G106, 8192, f32, False),
        ("decode zamba2 decode (6,6)@(6,8192)", D66, 8192, f32, False),
        ("decode zamba2 decode (6,6)@(6,2048)", D66, 2048, f32, False),
        ("decode zamba2 prefill (6,6)@(6,682*2048)", D66, 682 * 2048, f32,
         False),
        ("encode zamba2 prefill T=200 (10,6)@(6,133*2048)", G106, 133 * 2048,
         f32, False),
        ("encode zamba2 prefill T=200 (10,6)@(6,133*8192)", G106, 133 * 8192,
         f32, False),
        ("decode zamba2 prefill T=200 (6,6)@(6,133*8192)", D66, 133 * 8192,
         f32, False),
        ("decode zamba2 prefill T=200 (6,6)@(6,133*2048)", D66, 133 * 2048,
         f32, False),
        # the coding variants' edges: ragged F near conv2_2's and
        # Zamba2's prefill decode (scalar), an unaligned X (scalar), the
        # widest A (narrow)
        ("decode (6,6) ragged F=682*8192+1", D66, 682 * 8192 + 1, f32, False),
        ("encode ragged F=291843", G106, 291843, f32, False),
        ("encode unaligned X (10,6)@(6,291840)", G106, 291840, f32, False,
         True),
        ("decode (16,16) F=262144", D1616, 262144, f32, False),
    ] + adaptive_gemm_cases(torch) + [
        # the headline shape once more, last: two readings show the spread
        ("encode conv2_2 B=1 (again)", G106, 291840, f32, False),
    ]


# The (token count, k) of every coded GEMM the ``adaptive`` phase's Zamba2
# run gives (n = 10 throughout): its planner re-solves k° per GEMM from the
# pool's FakeClock telemetry, which is deterministic, so the plans are
# too.  k° = 6 at 4096 tokens and 7 at 8 on the prior; once the profiles
# are ready, the size-blind DeterministicDelay calibrates the worker phases
# to cost the same at any piece size, and k° falls (4, 2, 1 at 8 tokens;
# 3, 1 at 800).  The phase asserts that every skinny-GEMM launch of its run
# has one of the shapes these plans give.
ADAPTIVE_PLANS = ((4096, 6), (8, 7), (8, 4), (8, 2), (8, 1), (800, 3),
                  (800, 1))
ZAMBA2_FFN = ((2048, 8192), (8192, 2048))  # (d_in, d_out) of w_in, w_out


def adaptive_gemm_cases(torch) -> list:
    """The coding and piece products of ``ADAPTIVE_PLANS`` that the static
    plan's cases above do not hold already: per (T, k), t_p = T // k, the
    encode ``(10, k) @ (k, t_p d_in)``, the decode ``(k, k) @ (k, t_p
    d_out)`` and the piece ``(t_p, d_in) @ (d_in, d_out)`` of both FFN
    weight shapes."""
    import numpy as np
    from repro_torch.core.coding import vandermonde_generator

    have = {(4096 // 6, 6)}
    cases, pieces = [], set()
    for T, k in ADAPTIVE_PLANS:
        t_p = T // k
        if (t_p, k) in have:
            continue
        have.add((t_p, k))
        G = vandermonde_generator(N_WORKERS, k)
        D = np.linalg.inv(G[[0, 3, 4, 5, 6, 7, 8, 9][:k]])
        for d_in, d_out in ZAMBA2_FFN:
            cases.append((f"adaptive encode T={T} (10,{k})@({k},{t_p}*{d_in})",
                          G, t_p * d_in, torch.float32, False))
            cases.append((f"adaptive decode T={T} ({k},{k})@({k},{t_p}*"
                          f"{d_out})", D, t_p * d_out, torch.float32, False))
            if t_p not in (1, 2, 6, 16, 133, 682):  # the static cases' t_p
                pieces.add((t_p, d_in, d_out))
    for t_p, d_in, d_out in sorted(pieces):
        cases.append((f"adaptive piece {t_p}x{d_in}x{d_out}", (t_p, d_in),
                      d_out, torch.float32, False))
    # the autoscaler part's decode-step GEMM, (8, 2048) @ (2048, 8192), at
    # the (n, k) of the fleets its pinned series gives: (9, 7), (12, 8),
    # (11, 8); the (7, 7) decode is held above
    D8 = np.linalg.inv(vandermonde_generator(12, 8)[:8])
    for n, k in ((9, 7), (12, 8), (11, 8)):
        cases.append((f"autoscale encode ({n},{k})@({k},2048)",
                      vandermonde_generator(n, k), 2048, torch.float32,
                      False))
    cases.append(("autoscale decode (8,8)@(8,8192)", D8, 8192,
                  torch.float32, False))
    return cases


def coding_variants(F, dtype, aligned) -> tuple:
    """The coding variants the C side takes: ``narrow`` needs aligned
    pointers and whole 16-byte rows."""
    whole = F % (16 // dtype.itemsize) == 0
    return ("narrow", "scalar") if aligned and whole else ("scalar",)


def coding_variants_agree(torch, name, A, X, got, aligned) -> list:
    """Every coding variant that can run this product, launched on X and on
    a column block of it (whole 16-byte groups wide for ``narrow``), gives
    the bits of ``got``: one fmaf order whatever the variant."""
    from repro_torch.kernels import skinny_gemm as sg

    b, F = X.shape
    V = 16 // X.element_size()
    checked = []
    for v in coding_variants(F, X.dtype, aligned):
        c0 = F // 3 + 1
        c1 = 2 * F // 3 + 3
        if v == "narrow":
            c1 = c0 + (c1 - c0) // V * V
        whole = sg._launch(A, X, sg.coding_variant_plan(v, b, F, X.dtype))
        # a fresh copy: with one row (b = 1) the slice is already
        # contiguous, and a view would start off a 16-byte boundary
        part = sg._launch(A, X[:, c0:c1].clone(
                              memory_format=torch.contiguous_format),
                          sg.coding_variant_plan(v, b, c1 - c0, X.dtype))
        torch.cuda.synchronize()
        require(bool(torch.equal(whole, got)),
                f"{name}: variant {v} differs from the chosen plan's bits")
        require(bool(torch.equal(part, got[:, c0:c1])),
                f"{name}: variant {v}: a column block is not bit-identical "
                "to the whole")
        checked.append(v)
    return checked


def check_gemm(torch, timer, gen, name, A_src, F, dtype, headline,
               unaligned=False) -> dict:
    from repro_torch.kernels.skinny_gemm import (piece_plan, skinny_gemm,
                                                 skinny_gemm_plain)

    if isinstance(A_src, tuple):
        m, b = A_src
        A = _rand(torch, gen, (m, b), dtype, b ** -0.5)
    else:
        m, b = A_src.shape
        A = torch.from_numpy(A_src.copy()).to(dtype).cuda()
    if unaligned:  # contiguous, but 4 bytes past a 16-byte boundary
        buf = _rand(torch, gen, (b * F + 4,), dtype)
        X = buf[4 // buf.element_size():][: b * F].view(b, F)
        require(X.data_ptr() % 16 != 0, f"{name}: X is aligned")
    else:
        X = _rand(torch, gen, (b, F), dtype)
    plan = piece_plan(m, b, F, dtype, aligned=not unaligned)
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
    variants = (coding_variants_agree(torch, name, A, X, got, not unaligned)
                if plan.regime == "coding" and F >= 64 else [])
    # a contraction split is summed in a fixed order: run twice, same bits
    if plan.cluster > 1:
        require(bool(torch.equal(skinny_gemm(A, X), got)),
                f"{name}: two runs of the split-K GEMV differ")
    # tiled regime: a row block (still > 16 rows) has the rows' bits
    if plan.regime == "tiled" and m >= 2 * 17:
        r0, r1 = m // 4, m // 4 + max(17, m // 2)
        rows = skinny_gemm(A[r0:r1].contiguous(), X)
        require(bool(torch.equal(rows, got[r0:r1])),
                f"{name}: a row block is not bit-identical to the whole")
    item = X.element_size()
    n_bytes = (m * b + b * F + m * F) * item
    dn = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(n_bytes, 2.0 * m * b * F, dn)
    copy_ms = None
    if plan.regime == "coding":  # a device copy of as many bytes, the ceiling
        src = torch.empty(((m + b) // 2, F), dtype=dtype, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = timer.ms(lambda: dst.copy_(src))
    return {"case": name, "kernel": "skinny_gemm", "shape": [m, b, F],
            "dtype": dn, "headline": headline, "unaligned": unaligned,
            "plan": {"regime": plan.regime, "variant": plan.variant,
                     "tile": list(plan.tile), "threads": plan.threads,
                     "splits": plan.cluster, "blocks": plan.blocks},
            "variants_bit_identical": variants,
            "max_abs_err": float(err.max()), "tol_coef": coef,
            "err_over_tol": ratio, "max_abs_err_vs_f64": float(err64.max()),
            "ms": timer.ms(lambda: skinny_gemm(A, X)),
            "plain_ms": timer.ms(lambda: skinny_gemm_plain(A, X)),
            "library_ms": timer.ms(lambda: torch.matmul(A, X)),
            "copy_ms": copy_ms, "bound_ms": bound_ms, "bound_by": bound_by}


# the one-program backend's piece GEMM: n = 10 pieces of t_p rows in one
# launch, at Zamba2's two FFN weight shapes (d_in, d_out)
STACKED_T_P = (1, 2, 16, 17, 133, 682)
STACKED_W = ((2048, 8192), (8192, 2048))


def check_stacked(torch, timer, gen, t_p, b, F) -> dict:
    """``piece_gemm_stacked`` at n = 10: every piece bit for bit equal to
    its own ``skinny_gemm`` launch, within tolerance of the plain version
    and of an f64 product; timed beside the ten single launches and
    ``torch.matmul`` on the stacked rows."""
    from repro_torch.kernels.skinny_gemm import (piece_gemm_stacked,
                                                 piece_gemm_stacked_plain,
                                                 skinny_gemm, stacked_plan)

    n = N_WORKERS
    name = f"stacked {n}x{t_p}x{b}x{F}"
    P = _rand(torch, gen, (n, t_p, b), torch.float32, b ** -0.5)
    X = _rand(torch, gen, (b, F), torch.float32)
    plan = stacked_plan(n, t_p, b, F)
    got = piece_gemm_stacked(P, X)
    singles = [skinny_gemm(P[i], X) for i in range(n)]
    torch.cuda.synchronize()
    require(got.shape == (n, t_p, F), f"{name}: shape")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    for i, one in enumerate(singles):
        require(bool(torch.equal(got[i], one)),
                f"{name}: piece {i} differs from its own launch")
    want = piece_gemm_stacked_plain(P, X)
    S = P.abs() @ X.abs()
    coef = 2.0 * (b + 2) * 2.0 ** -24
    err = (got - want).abs()
    ratio = float((err / (coef * S + 1e-30)).max())
    require(ratio <= 1.0, f"{name}: kernel differs from plain version, "
                          f"err/tol = {ratio:.3g}")
    err64 = (got.double() - P.double() @ X.double()).abs()
    ratio64 = float((err64 / (coef * S.double() + 1e-30)).max())
    require(ratio64 <= 1.0, f"{name}: kernel differs from the f64 product, "
                            f"err/tol = {ratio64:.3g}")
    rows = P.reshape(n * t_p, b)
    n_bytes = (n * t_p * b + b * F + n * t_p * F) * 4
    bound_ms, bound_by = bound(n_bytes, 2.0 * n * t_p * b * F, "float32")
    return {"case": name, "kernel": "piece_gemm_stacked",
            "shape": [n, t_p, b, F], "dtype": "float32",
            "headline": (t_p, b, F) == (1, 2048, 8192),
            "plan": {"regime": plan.regime, "tile": list(plan.tile),
                     "splits": plan.cluster, "row_groups": plan.grid[1]
                     if plan.regime != "tiled" else 1,
                     "blocks": plan.blocks},
            "pieces_bit_identical": n,
            "max_abs_err": float(err.max()), "tol_coef": coef,
            "err_over_tol": ratio, "max_abs_err_vs_f64": float(err64.max()),
            "ms": timer.ms(lambda: piece_gemm_stacked(P, X)),
            "ten_launches_ms": timer.ms(
                lambda: [skinny_gemm(P[i], X) for i in range(n)]),
            "plain_ms": timer.ms(lambda: piece_gemm_stacked_plain(P, X)),
            "library_ms": timer.ms(lambda: torch.matmul(rows, X)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_cases(torch):
    """(name, x shape, slice of W or None, w shape, stride, dtype, headline)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        # VGG16 (224, n=10, k=6) worker pieces at B = 1 and 4, the remainder
        # slices the master keeps (every segment has depth 1) and the local
        # layers
        ("conv2_2 piece B=1", (1, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, True),
        ("conv2_2 piece B=4", (4, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, False),
        ("conv2_2 10 pieces folded", (10, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, False),
        ("conv2_2 remainder slice", (1, 128, 114, 114), (108, 114), (128, 128, 3, 3), 1, f32, False),
        ("conv3_1 piece B=1", (1, 128, 58, 11), None, (256, 128, 3, 3), 1, f32, False),
        ("conv3_1 piece B=4", (4, 128, 58, 11), None, (256, 128, 3, 3), 1, f32, False),
        ("conv3_2 piece B=1", (1, 256, 58, 11), None, (256, 256, 3, 3), 1, f32, False),
        ("conv3_2 piece B=4", (4, 256, 58, 11), None, (256, 256, 3, 3), 1, f32, False),
        ("conv3_2 remainder slice", (1, 256, 58, 58), (54, 58), (256, 256, 3, 3), 1, f32, False),
        ("conv4_1 piece B=1", (1, 256, 30, 6), None, (512, 256, 3, 3), 1, f32, False),
        ("conv4_1 piece B=4", (4, 256, 30, 6), None, (512, 256, 3, 3), 1, f32, False),
        ("conv4_2 piece B=1", (1, 512, 30, 6), None, (512, 512, 3, 3), 1, f32, False),
        ("conv4_2 piece B=4", (4, 512, 30, 6), None, (512, 512, 3, 3), 1, f32, False),
        ("conv4_2 remainder slice", (1, 512, 30, 30), (24, 30), (512, 512, 3, 3), 1, f32, False),
        ("conv5_x piece B=1", (1, 512, 16, 4), None, (512, 512, 3, 3), 1, f32, False),
        ("conv5_x piece B=4", (4, 512, 16, 4), None, (512, 512, 3, 3), 1, f32, False),
        ("conv5_x remainder slice", (1, 512, 16, 16), (12, 16), (512, 512, 3, 3), 1, f32, False),
        ("conv1_1 local B=1", (1, 3, 226, 226), None, (64, 3, 3, 3), 1, f32, False),
        ("conv1_2 local B=1", (1, 64, 226, 226), None, (64, 64, 3, 3), 1, f32, False),
        ("conv1_2 local B=4", (4, 64, 226, 226), None, (64, 64, 3, 3), 1, f32, False),
        ("conv2_1 local B=1", (1, 64, 114, 114), None, (128, 64, 3, 3), 1, f32, False),
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
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain, conv_plan

    x = _rand(torch, gen, xs, dtype, 0.5)
    if sl is not None:
        x = x[..., sl[0]:sl[1]]  # a width slice, read in place
    c_out, c_in, K, _ = ws
    w = _rand(torch, gen, ws, dtype, (c_in * K * K) ** -0.5)
    plan = conv_plan(x.shape, ws, stride, dtype)
    got = conv2d(x, w, stride)
    torch.cuda.synchronize()
    want = conv2d_plain(x, w, stride)
    # an R-split is summed in a fixed order: run twice, same bits
    if plan.cluster > 1:
        require(bool(torch.equal(conv2d(x, w, stride), got)),
                f"{name}: two runs of the split conv differ")
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
            "plan": {"tile": list(plan.tile), "splits": plan.cluster,
                     "blocks": plan.blocks},
            "max_abs_err": float(err.max()), "tol_coef": coef,
            "err_over_tol": ratio, "max_abs_err_vs_f64": float(err64.max()),
            "ms": timer.ms(lambda: conv2d(x, w, stride)),
            "plain_ms": timer.ms(lambda: conv2d_plain(x, w, stride)),
            "library_ms": timer.ms(lambda: F.conv2d(x, w, stride=stride)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_conv_fold(torch, gen, name, xs, ws) -> dict:
    """Property (ii): the functional path's folded launch (n pieces stacked
    into N) gives each piece the bits of the pool's per-piece launch."""
    from repro_torch.kernels.conv2d import conv2d, conv_plan

    x = _rand(torch, gen, xs, torch.float32, 0.5)
    w = _rand(torch, gen, ws, torch.float32, (ws[1] * ws[2] * ws[3]) ** -0.5)
    folded = conv2d(x, w, 1)
    for i in range(xs[0]):
        require(bool(torch.equal(conv2d(x[i:i + 1], w, 1), folded[i:i + 1])),
                f"{name}: piece {i} alone differs from the folded launch")
    plans = [conv_plan(xs, ws, 1), conv_plan((1,) + tuple(xs[1:]), ws, 1)]
    return {"case": name, "pieces": xs[0], "bit_identical": True,
            "plans": [{"tile": list(p.tile), "splits": p.cluster}
                      for p in plans]}


def ssd_cases(torch):
    """(name, B, T, H, P, N, chunk, h0, dtype, entry, headline); entry
    "scan" is one call for the whole sequence (``ssd_chunk_scan``, what
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
        # widths that are no multiple of 4: 4-byte copies, partial tiles
        ("odd widths P=18 N=10 L=42, h0", 3, 100, 5, 18, 10, 42, True, f32,
         "scan", False),
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


def ssd_pass_work(B, T, H, P, N, chunk, item, h0) -> dict:
    """(FLOPs, bytes) of each pass of ``ssd_chunk_scan``: the products over
    the rows the sequence has (their sum is ``ssd_work``; the state pass
    adds one multiply-add per state element and chunk), each input read
    once and each output written once; ``item`` is x's, Bm's and Cm's
    element size (G, S, the states, dt and A are f32)."""
    c = -(-T // chunk)
    cb = st = out = 0
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        tri = n * (n + 1) // 2
        cb += tri * N
        st += H * n * P * N
        out += H * (tri * P + n * N * P)
    state = B * c * H * P * N * 4
    x, bc, y = B * T * H * P * item, B * T * N * item, B * T * H * P * item
    dt, G, ce = B * T * H * 4 + H * 4, B * c * chunk * chunk * 4, B * c * H * 4
    h = B * H * P * N * 4
    return {"cb": (2.0 * B * cb, 2 * bc + G),
            "states": (2.0 * B * st, x + bc + dt + state + ce),
            "state_pass": (2.0 * B * c * H * P * N,
                           2 * state + ce + h * (2 if h0 else 1)),
            "out": (2.0 * B * out, x + bc + dt + G + state + y)}


def bound_3xtf32(n_bytes: float, flops: float) -> float:
    """The least time at the tensor cores' dense TF32 rate, each product
    taken three times (3xTF32), or at the memory rate: ms."""
    return max(n_bytes / PEAK_BYTES_PER_S,
               3.0 * flops / PEAK_FLOPS["tf32"]) * 1e3


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
                                               ssd_chunk_scan_passes_plain,
                                               ssd_chunk_scan_plain, ssd_plan)

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
    y2, hT2 = run()
    require(bool(torch.equal(y, y2)) and bool(torch.equal(hT, hT2)),
            f"{name}: two runs of the kernels differ")
    # the wrapper's host side: 20 calls queued, no synchronise between
    t0 = time.perf_counter()
    for _ in range(20):
        run()
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    py, ph = plain()
    require(tuple(y.shape) == (B, T, H, P) and y.dtype == dtype
            and tuple(hT.shape) == (B, H, P, N) and hT.dtype == torch.float32,
            f"{name}: shapes/dtypes")
    require(bool(torch.isfinite(y.float()).all())
            and bool(torch.isfinite(hT).all()), f"{name}: non-finite")
    fy, fh = ssd_f64_scan(torch, x, dt, A, Bm, Cm, h)
    qy, qh = ssd_chunk_scan_passes_plain(x, dt, A, Bm, Cm, h, chunk)
    errs, ratios, coef_y, max_cum = ssd_compare(
        torch, name, (x, dt, A, Bm, Cm, h), chunk,
        {"plain": (py, ph), "f64 scan": (fy, fh),
         "passes plain": (qy, qh)}, (y, hT))
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
            "plan": {k: {"grid": list(p.grid), "smem": p.smem,
                         "blocks_per_sm": p.blocks_per_sm}
                     for k, p in ssd_plan(B, T, H, P, N, chunk).items()},
            "ms": timer.ms(run), "plain_ms": timer.ms(plain),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_3xtf32_ms": bound_3xtf32(n_bytes, flops),
            "host_us_per_call": host_us}


def check_ssd_passes(torch, timer, gen) -> list[dict]:
    """Each pass of the SSD kernel at the headline shape (Zamba2's prefill,
    B=8, T=512, with h0), the kernel and its plain version given the same
    inputs (the plain passes' outputs of the pass before), held against the
    plain pass and the same pass in f64 with ``ssd_compare``'s tolerance."""
    import repro_torch.kernels.ssd_chunk  # noqa: F401
    K = sys.modules["repro_torch.kernels.ssd_chunk"]

    B, T, H, P, N, chunk = 8, 512, 64, 64, 64, 128
    x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, True,
                                     torch.float32)
    d64 = lambda *ts: [t.double() for t in ts]
    G = K.ssd_cb_plain(Bm, Cm, chunk)
    S, ce = K.ssd_states_plain(x, dt, A, Bm, chunk)
    Hin, hT = K.ssd_state_pass_plain(S, ce, h)
    y = K.ssd_out_plain(x, dt, A, Cm, G, Hin, chunk)
    # magnitudes: the same passes of |x|, |Bm|, |Cm|, |h0|
    aG = K.ssd_cb_plain(Bm.abs(), Cm.abs(), chunk)
    aS, _ = K.ssd_states_plain(x.abs(), dt, A, Bm.abs(), chunk)
    aHin, ahT = K.ssd_state_pass_plain(aS, ce, h.abs())
    ay = K.ssd_out_plain(x.abs(), dt, A, Cm.abs(), aG, aHin, chunk)
    c = -(-T // chunk)
    dA = (dt * A).reshape(B, c, chunk, H)
    max_cum = float(dA.cumsum(2).abs().max())
    coef = 4.0 * (N + chunk + max_cum) * 2.0 ** -24
    passes = {
        "cb": (lambda: K.ssd_cb(Bm, Cm, chunk),
               lambda: K.ssd_cb_plain(Bm, Cm, chunk),
               lambda: K.ssd_cb_plain(*d64(Bm, Cm), chunk), (aG,)),
        "states": (lambda: K.ssd_states(x, dt, A, Bm, chunk),
                   lambda: K.ssd_states_plain(x, dt, A, Bm, chunk),
                   lambda: K.ssd_states_plain(*d64(x, dt, A, Bm), chunk),
                   (aS, ce.abs())),
        "state_pass": (lambda: K.ssd_state_pass(S, ce, h),
                       lambda: K.ssd_state_pass_plain(S, ce, h),
                       lambda: K.ssd_state_pass_plain(*d64(S, ce, h)),
                       (aHin, ahT)),
        "out": (lambda: K.ssd_out(x, dt, A, Cm, G, Hin, chunk),
                lambda: K.ssd_out_plain(x, dt, A, Cm, G, Hin, chunk),
                lambda: K.ssd_out_plain(*d64(x, dt, A, Cm, G, Hin), chunk),
                (ay,)),
    }
    work = ssd_pass_work(B, T, H, P, N, chunk, 4, True)
    plan = K.ssd_plan(B, T, H, P, N, chunk)
    out = []
    for name, (run, plain, f64, scales) in passes.items():
        tup = lambda r: r if isinstance(r, tuple) else (r,)
        got = tup(run())
        torch.cuda.synchronize()
        require(bool(all(torch.equal(a, b) for a, b in zip(got, tup(run())))),
                f"SSD pass {name}: two runs differ")
        refs = {"plain": tup(plain()), "f64": tup(f64())}
        errs, ratios = {}, {}
        for ref_name, ref in refs.items():
            for i, (a, b, sc) in enumerate(zip(got, ref, scales)):
                require(a.shape == b.shape and bool(torch.isfinite(a).all()),
                        f"SSD pass {name}: output {i} shape or non-finite")
                e = (a.double() - b.double()).abs()
                key = f"out{i} vs {ref_name}"
                errs[key] = float(e.max())
                ratios[key] = float((e / (coef * sc.double() + 1e-30)).max())
                require(ratios[key] <= 1.0, f"SSD pass {name}: {key} err/tol "
                                            f"= {ratios[key]:.3g}")
        flops, n_bytes = work[name]
        bound_ms, bound_by = bound(n_bytes, flops, "float32")
        p = plan[name]
        out.append({
            "case": f"zamba2 prefill B=8 T=512, h0: pass {name}",
            "kernel": f"ssd_chunk.{name}", "dtype": "float32",
            "headline": True,
            "plan": {"grid": list(p.grid), "threads": p.threads,
                     "smem": p.smem, "blocks_per_sm": p.blocks_per_sm},
            "max_abs_err": errs["out0 vs plain"], "errors": errs,
            "err_over_tol": max(ratios.values()), "ratios": ratios,
            "tol_coef": coef, "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
            "ms": timer.ms(run), "plain_ms": timer.ms(plain),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_3xtf32_ms": bound_3xtf32(n_bytes, flops)})
    return out


def phase_kernels(torch) -> list[dict]:
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [check_gemm(torch, timer, gen, *c) for c in gemm_cases(torch)]
    cases += [check_stacked(torch, timer, gen, t_p, b, F)
              for b, F in STACKED_W for t_p in STACKED_T_P]
    cases += [check_conv(torch, timer, gen, *c) for c in conv_cases(torch)]
    cases += [check_ssd(torch, timer, gen, *c) for c in ssd_cases(torch)]
    cases += check_ssd_passes(torch, timer, gen)
    folds = [check_conv_fold(torch, gen, f"{n}: 10 pieces folded vs one by "
                             "one", (10,) + xs, ws)
             for n, xs, ws in (("conv4_2", (512, 30, 6), (512, 512, 3, 3)),
                               ("conv5_x", (512, 16, 4), (512, 512, 3, 3)))]
    emit({"phase": "kernels", "timing": "median of 15 calls, CUDA events, "
          "L2 overwritten before each call, TF32 off", "cases": cases,
          "folded_vs_pieces": folds})
    return cases


def time_kernels(torch, checkout: str) -> None:
    """Only time ``skinny_gemm``, ``conv2d`` and ``ssd_chunk_scan`` of the
    ``repro_torch`` under ``checkout/src`` at this script's f32 cases
    (the SSD's whole-sequence ones), as the ``kernels`` phase
    times them, and print one JSON line: run it on two checkouts in one
    call (parent, change, change, parent) to hold two versions of the
    kernels against each other on one card.  The wrappers' signatures are
    the same in every version of the port."""
    import repro_torch
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.skinny_gemm import skinny_gemm
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan

    require(os.path.realpath(repro_torch.__file__).startswith(
        os.path.realpath(checkout)), f"repro_torch not from {checkout}")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, A_src, F, dtype, *rest in gemm_cases(torch):
        if dtype != torch.float32 or any(rest[1:]):
            continue
        m, b = A_src if isinstance(A_src, tuple) else A_src.shape
        A = _rand(torch, gen, (m, b), dtype, b ** -0.5)
        X = _rand(torch, gen, (b, F), dtype)
        rows.append({"case": name, "kernel": "skinny_gemm",
                     "ms": timer.ms(lambda: skinny_gemm(A, X))})
    for name, xs, sl, ws, stride, dtype, _ in conv_cases(torch):
        if dtype != torch.float32:
            continue
        x = _rand(torch, gen, xs, dtype, 0.5)
        if sl is not None:
            x = x[..., sl[0]:sl[1]]
        w = _rand(torch, gen, ws, dtype, (ws[1] * ws[2] * ws[3]) ** -0.5)
        rows.append({"case": name, "kernel": "conv2d",
                     "ms": timer.ms(lambda: conv2d(x, w, stride))})
    for name, B, T, H, P, N, chunk, h0, dtype, entry, _ in ssd_cases(torch):
        if dtype != torch.float32 or entry != "scan":
            continue
        x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, h0,
                                         dtype)
        rows.append({"case": name, "kernel": "ssd_chunk", "ms": timer.ms(
            lambda: ssd_chunk_scan(x, dt, A, Bm, Cm, h, chunk))})
    emit({"phase": "time_kernels", "source": os.path.dirname(
        repro_torch.__file__), "nvidia_smi": nvidia_smi_line(),
          "cases": rows})


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
    from repro_torch.dist import FakeClock, MeshExecutor
    from repro_torch.dist.backend import CodedOp
    from repro_torch.kernels.skinny_gemm import piece_gemm_stacked
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
        mx = MeshExecutor(dead=(1,), stragglers=(2,))
        try:
            got_c = coded_conv2d(x, w, code, spec, executor=ex)
            rep_c = ex.last_report
            got_m = coded_matmul(xm, wm, code, executor=ex)
            rep_m = ex.last_report
            # the one-program backend, the same fault pattern: the same
            # subset and the same bytes
            mesh_c = coded_conv2d(x, w, code, spec, executor=mx)
            sub_c = mx.last_report.subset
            s0 = piece_gemm_stacked.launches
            mesh_m = coded_matmul(xm, wm, code, executor=mx)
            sub_m = mx.last_report.subset
            mesh_m2 = coded_matmul(xm, wm, code, executor=mx)  # a replay
            stacked = piece_gemm_stacked.launches - s0
            # a replay of the captured graph against the eager program
            t_p = 1030 // code.k
            op = CodedOp("matmul", code, xm[: code.k * t_p].reshape(
                code.k, t_p, -1), wm)
            eager = MeshExecutor.program(op, tuple(sub_m), op.x)
            replay = mx.run_op(op)
            torch.cuda.synchronize()
        finally:
            ex.close()
            mx.close()
        require(sub_c == rep_c.subset and sub_m == rep_m.subset,
                f"{code}: the mesh consumed {sub_c}/{sub_m}, the pool "
                f"{rep_c.subset}/{rep_m.subset}")
        require(bool(torch.equal(mesh_c, got_c)),
                f"{code}: mesh conv differs from the pool's bits")
        require(bool(torch.equal(mesh_m, got_m))
                and bool(torch.equal(mesh_m2, got_m)),
                f"{code}: mesh matmul differs from the pool's bits")
        require(bool(torch.equal(replay, eager)),
                f"{code}: a graph replay differs from the eager program")
        # the first matmul run calls the stacked wrapper twice: its eager
        # warm-up and its capture; the second run is a replay, which calls
        # no wrapper (the replay's bits are checked against the eager
        # program above)
        require(stacked == 2 and mx.graph_count == 2
                and mx.replay_count == 4,
                f"{code}: {stacked} stacked wrapper calls, {mx.graph_count} "
                f"graphs, {mx.replay_count} replays (design 2, 2, 4)")
        for op_name, got, want, rep, R in (
                ("conv2d conv4_2", got_c, y_conv, rep_c, 512 * 9),
                ("matmul 1030x1024x4096", got_m, y_mm, rep_m, 1024)):
            # coded vs uncoded: the pieces carry the f32 roundoff of a
            # length-R sum (~sqrt(R) u, u = 2^-24) and the decode amplifies
            # it by |D|_inf |G_S|_inf for the subset that arrived; selection
            # schemes decode by gather (amplification 1)
            amp = decode_amplification(code, rep.subset)
            tol = amp * R ** 0.5 * 2.0 ** -24 * float(want.abs().max())
            err = float((got - want).abs().max())
            require(got.shape == want.shape, f"{op_name}: shape")
            require(err <= tol, f"coded {op_name} under {code}: err {err} > "
                                f"{tol}")
            rows.append({"op": op_name, "scheme": code.scheme_name,
                         "n": code.n, "k": code.k, "max_abs_err": err,
                         "tol": tol, "decode_amplification": amp,
                         "subset": rep.subset, "redispatched": rep.redispatched,
                         "failures": rep.failures,
                         "t_complete": rep.t_complete,
                         "mesh_bit_identical": True})
    emit({"phase": "coded_ops", "faults": "dead={1}, straggler={2: 50x}",
          "clock": "FakeClock + DeterministicDelay(1.0)", "ops": rows,
          "mesh": "MeshExecutor(dead=(1,), stragglers=(2,)): same subset, "
                  "same bytes; a graph replay equals the eager program",
          "mesh_matrix": mesh_matrix(torch)})


def mesh_matrix(torch) -> dict:
    """Every scheme x {no fault, dead 1, straggler 2} x {matmul, conv} at
    small shapes, n = 5: the mesh's graph replay bit for bit equal to the
    pool's result, from the same subset."""
    from repro_torch.core import (ConvSpec, coded_conv2d, coded_matmul,
                                  get_scheme, scheme_names)
    from repro_torch.dist import (CodedExecutor, DeterministicDelay,
                                  FakeClock, FaultPlan, MeshExecutor)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    xm = _rand(torch, gen, (13, 8), torch.float32)
    wm = _rand(torch, gen, (8, 16), torch.float32)
    spec = ConvSpec(c_in=3, c_out=4, h_in=12, w_in=26, kernel=3, stride=1,
                    batch=2)
    xc = _rand(torch, gen, (2, 3, 12, 26), torch.float32)
    wc = _rand(torch, gen, (4, 3, 3, 3), torch.float32)
    faults = {"none": ({}, {}),
              "dead 1": ({"dead": frozenset({1})}, {"dead": (1,)}),
              "straggler 2": ({"straggler": {2: 50.0}}, {"stragglers": (2,)})}
    cells = 0
    for name in scheme_names():
        cls = get_scheme(name)
        code = cls.make(5, 3) if name in ("mds", "lt") else cls.make(5)
        for label, (fp, mk) in faults.items():
            for op, run in (
                    ("matmul", lambda ex: coded_matmul(xm, wm, code,
                                                       executor=ex)),
                    ("conv2d", lambda ex: coded_conv2d(xc, wc, code, spec,
                                                       executor=ex))):
                ex = CodedExecutor(code.n, clock=FakeClock(),
                                   delay_model=DeterministicDelay(1.0),
                                   fault_plan=FaultPlan(**fp))
                mx = MeshExecutor(**mk)
                try:
                    got_t, got_m = run(ex), run(mx)
                    subs = (ex.last_report.subset, mx.last_report.subset)
                    torch.cuda.synchronize()
                finally:
                    ex.close()
                    mx.close()
                require(subs[0] == subs[1] and bool(torch.equal(got_t, got_m)),
                        f"mesh vs pool, {name} {label} {op}: subsets {subs}, "
                        "or other bytes")
                cells += 1
    return {"cells": cells, "bit_identical": cells,
            "shapes": "matmul 13x8 @ 8x16, conv (2,3,12,26) x (4,3,3,3), "
                      "n = 5"}


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


def device_rows_named(prof, part: str) -> list[dict]:
    """The profile's device-kernel rows whose name holds ``part``."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA \
                or part not in ev.key:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append({"name": ev.key[:60], "ms": float(t) / 1e3,
                     "calls": int(ev.count)})
    return sorted(rows, key=lambda r: -r["ms"])


def coding_rows(prof, where: str) -> list[dict]:
    """The coding GEMM's device rows, each of them the ``narrow`` variant:
    no main-path encode or decode has an unaligned operand or a ragged F
    (``index_select`` and ``reshape`` give fresh or contiguous storage)."""
    rows = device_rows_named(prof, "coding_gemm")
    require(bool(rows) and all("narrow" in r["name"] for r in rows),
            f"{where}: the main path ran other coding kernels: {rows}")
    return rows


def runtime_calls(prof) -> dict:
    """The profile's CUDA runtime calls on the host (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaStreamSynchronize``, ...): calls and ms."""
    from torch.autograd import DeviceType

    return {ev.key: {"calls": int(ev.count),
                     "ms": float(ev.self_cpu_time_total) / 1e3}
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) != DeviceType.CUDA
            and ev.key.startswith("cuda")}


def latency_rows(buckets, by_id) -> tuple:
    """TTFT per bucket (from ``generate``'s entry and from the previous
    bucket's end) and decode ms per token, from the completions."""
    ttft, own, per_tok, prev_end = {}, {}, {}, 0.0
    for ids, T, new in buckets:
        first = max(by_id[j].first_token_s for j in ids)
        last = max(by_id[j].latency_s for j in ids)
        ttft[T] = first * 1e3
        own[T] = (first - prev_end) * 1e3
        per_tok[T] = (last - first) / max(new - 1, 1) * 1e3
        prev_end = last
    return ttft, own, per_tok


def t_compute_stats(values: list[float]) -> dict:
    """Median, p90, max and sum in ms of real-clock times: a piece's
    compute (from its launch to its own stream's synchronise), or a mesh
    run's wall (from its replay to its synchronise)."""
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
        if profile:  # a check too: its coding rows must all be `narrow`
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
            prof.__enter__()
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
            prof_out = device_time_of(prof)
            prof_out["idle_share"] = max(
                0.0, 1.0 - prof_out["device_ms"] / wall_ms)
            prof_out["coding_rows"] = coding_rows(prof, label)
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


def record_steps(eng) -> list:
    """Wrap the engine's prefill and decode steps so that each step's
    last-position logits are appended to the returned list (until
    ``eng._bind_steps()`` unwraps them)."""
    steps, vocab = [], eng.cfg.vocab

    def recording(fn):
        def wrapped(*args):
            logits, cache = fn(*args)
            steps.append(logits[:, 0, :vocab])
            return logits, cache
        return wrapped

    eng._prefill, eng._decode = (recording(eng._prefill),
                                 recording(eng._decode))
    return steps


def zamba2_expected(cfg, n_live: int) -> dict:
    """Launches and coded runs the design implies for the two buckets.

    SSD: one ``ssd_chunk_scan`` call per Mamba2 layer per prefill, which
    launches each of the kernel's four passes once; decode steps run the
    recurrence in plain torch.  Coded GEMMs: each of the shared block's calls runs 3 FFN
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
        steps = record_steps(eng)
        reports = []
        ex.on_report = reports.append
        torch.cuda.synchronize()

        # ---- the counted run starts here ----------------------------------
        skinny_gemm.launches = 0
        ssd_chunk.launches = 0
        ssd_chunk.pass_launches = dict.fromkeys(ssd_chunk.pass_launches, 0)
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"skinny_gemm": skinny_gemm.launches,
                  "ssd_chunk": ssd_chunk.launches}
        counts.update({f"ssd_chunk.{k}": n
                       for k, n in ssd_chunk.pass_launches.items()})
        # ---- the counted run ends here ------------------------------------
        ex.on_report = None
        eng._bind_steps()
        runs, dispatches = ex.run_count, ex.pool.dispatch_count
        require(counts["ssd_chunk"] > 0 and counts["skinny_gemm"] > 0,
                f"a kernel of the path was never launched: {counts}")
        require(counts["ssd_chunk"] == want_counts["ssd_chunk"],
                f"{counts['ssd_chunk']} SSD launches, the design implies "
                f"{want_counts['ssd_chunk']}")
        for k in ssd_chunk.pass_launches:  # every call runs the 4 passes
            require(counts[f"ssd_chunk.{k}"] == want_counts["ssd_chunk"],
                    f"{counts[f'ssd_chunk.{k}']} launches of SSD pass {k}, "
                    f"the design implies {want_counts['ssd_chunk']}")
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
        profile["runtime_calls"] = runtime_calls(prof)
        profile["coding_rows"] = coding_rows(prof, "zamba2")
        ssd_rows = device_rows_named(prof, "ssd_")
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
    refs = []  # the uncoded logits of each served step, for zamba2_mesh
    for ids, T, new in buckets:
        refs += teacher_forced_refs(torch, cfg, params, reqs, ids, T, new,
                                    np.stack([by_id[j].tokens for j in ids]))
    quality = hold_to_uncoded("zamba2", buckets, out, steps, refs)

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

    ttft, own, per_tok = latency_rows(buckets, by_id)
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
          **quality, "layer0_ssd": layer_ssd,
          "ssd_passes": {"launches": {k: counts[f"ssd_chunk.{k}"]
                                      for k in ssd_chunk.pass_launches},
                         "device_rows": ssd_rows},
          "profile": profile})
    threaded = {"wall_s": wall_s, "ttft_ms": ttft,
                "decode_ms_per_token": per_tok, "coded_runs": runs,
                "virtual_completion_s": sum(r.t_complete for r in reports),
                "launches": counts, "profile": profile}
    return counts, {"cfg": cfg, "params": params, "reqs": reqs,
                    "buckets": buckets, "out": out, "steps": steps,
                    "refs": refs, "threaded": threaded}


# ---------------------------------------------------------------------------
# phase 6: the same Zamba2 serving on the one-program backend
# ---------------------------------------------------------------------------

def zamba2_mesh_expected(cfg) -> dict:
    """Programs, graphs and launches the mesh's design implies for the two
    buckets: a program per (token count, weight shape) of the coded steps
    (w_in and w_gate share one), a CUDA graph per (token count, weight).
    Each graph's program runs once eagerly and once under capture, each
    calling the stacked piece wrapper once and the skinny GEMM's twice (an
    MDS encode and a decode); every coded run is then one replay, whose
    device kernels are one piece kernel and two coding kernels."""
    runs = zamba2_expected(cfg, N_WORKERS)["coded_runs"]
    t_ps = set()
    for n_req, T, new in ZAMBA2_BUCKETS:
        if n_req * T >= ZAMBA2_K:
            t_ps.add(n_req * T // ZAMBA2_K)
        if new > 1 and n_req >= ZAMBA2_K:
            t_ps.add(n_req // ZAMBA2_K)
    graphs = 3 * len(t_ps)
    ssd = cfg.n_layers * len(ZAMBA2_BUCKETS)
    return {"coded_runs": runs, "programs": 2 * len(t_ps), "graphs": graphs,
            "wrapper_calls_first_run": {
                "piece_gemm_stacked": 2 * graphs,
                "skinny_gemm": 4 * graphs, "ssd_chunk": ssd},
            "launches_replayed_run": {
                "piece_gemm_stacked": runs, "skinny_gemm": 2 * runs,
                "ssd_chunk": ssd}}


def zero_launch_counters() -> None:
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.skinny_gemm import piece_gemm_stacked, skinny_gemm
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    skinny_gemm.launches = 0
    piece_gemm_stacked.launches = 0
    conv2d.launches = 0
    ssd_chunk.launches = 0
    ssd_chunk.pass_launches = dict.fromkeys(ssd_chunk.pass_launches, 0)


def read_launch_counters() -> dict:
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.skinny_gemm import piece_gemm_stacked, skinny_gemm
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    counts = {"skinny_gemm": skinny_gemm.launches,
              "piece_gemm_stacked": piece_gemm_stacked.launches,
              "conv2d": conv2d.launches, "ssd_chunk": ssd_chunk.launches}
    counts.update({f"ssd_chunk.{k}": n
                   for k, n in ssd_chunk.pass_launches.items()})
    return counts


def phase_zamba2_mesh(torch, z: dict) -> dict:
    """The zamba2 phase's requests on the mesh.  A replay calls no kernel
    wrapper, so the launches this phase reports for the coded GEMMs are the
    device's: kernel instances in the profiled run's device rows (every
    coded run of it a replay), beside its ``cudaGraphLaunch`` count."""
    import numpy as np
    from repro_torch.dist import MeshExecutor
    from repro_torch.serving import Engine

    cfg, params, reqs, buckets = z["cfg"], z["params"], z["reqs"], z["buckets"]
    want = zamba2_mesh_expected(cfg)
    n_tokens = sum(r.max_new for r in reqs)
    ex = MeshExecutor(dead=(1,), stragglers=(2,))
    # the same program run eagerly on every call (no graph): the yardstick
    # that says what the graphs themselves buy
    eager = MeshExecutor(dead=(1,), stragglers=(2,))
    eager._replay = lambda op, subset, key: MeshExecutor.program(
        op, subset, op.x)

    def timed(executor, label):
        eng.executor = executor
        reps = []
        executor.on_report = reps.append
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        executor.on_report = None
        require(all(np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(out, got)),
                f"zamba2_mesh {label}: other tokens than the first mesh run")
        ttft, own, per_tok = latency_rows(buckets, {c.rid: c for c in got})
        return {"executor": label, "wall_s": wall,
                "tokens_per_s": n_tokens / wall, "ttft_ms": ttft,
                "ttft_own_bucket_ms": own, "decode_ms_per_token": per_tok,
                "run_wall_ms": t_compute_stats([r.wall_s for r in reps])}

    def profiled(executor):
        from torch.profiler import ProfilerActivity, profile as tprof

        eng.executor = executor
        r0 = executor.run_count
        torch.cuda.synchronize()
        zero_launch_counters()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = eng.generate(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        wrappers = read_launch_counters()
        require(all(np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(out, got)),
                "a profiled mesh run gave other tokens")
        profile = device_time_of(prof)
        profile["runtime_calls"] = runtime_calls(prof)
        profile["wall_ms"] = wall_ms
        profile["idle_share"] = max(0.0, 1.0 - profile["device_ms"] / wall_ms)
        profile["piece_rows"] = device_rows_named(prof, "piece_")
        profile["coding_rows"] = coding_rows(prof, "zamba2_mesh")
        return profile, wrappers, executor.run_count - r0

    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, ZAMBA2_K), executor=ex)
        steps = record_steps(eng)
        reports = []
        ex.on_report = reports.append
        torch.cuda.synchronize()

        # ---- the first run: every program warmed up and captured ---------
        zero_launch_counters()
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        first_calls = read_launch_counters()
        ex.on_report = None
        eng._bind_steps()
        built = {"programs": ex.compile_count, "graphs": ex.graph_count,
                 "replays": ex.replay_count, "runs": ex.run_count,
                 "dispatches": ex.pool.dispatch_count}
        require(first_calls["conv2d"] == 0,
                f"{first_calls['conv2d']} conv launches")
        for k, n in first_calls.items():
            if k == "conv2d":
                continue
            design = want["wrapper_calls_first_run"][k.split(".")[0]]
            require(n == design, f"zamba2_mesh first run: {n} {k} wrapper "
                                 f"calls, the design implies {design}")
        require(built["runs"] == len(reports) == built["replays"]
                == want["coded_runs"],
                f"zamba2_mesh: {built}, {len(reports)} reports, the design "
                f"implies {want['coded_runs']} runs, each a replay")
        require(built["programs"] == want["programs"]
                and built["graphs"] == want["graphs"],
                f"zamba2_mesh: {built}, the design implies "
                f"{want['programs']} programs and {want['graphs']} graphs")
        for r in reports:
            require(1 not in r.subset and 2 not in r.subset,
                    f"a coded run used a faulty lane: subset {r.subset}")

        # ---- turns, every graph captured: graph, eager, eager, graph -----
        timed(eager, "eager (warm-up)")
        turns = [timed(ex, "graph"), timed(eager, "eager"),
                 timed(eager, "eager"), timed(ex, "graph")]

        # ---- the profiled runs: the counted one replays only -------------
        g0 = ex.graph_count
        profile, wrappers, runs2 = profiled(ex)
        require(ex.graph_count == g0, "a later run captured new graphs")
        eager_profile, _, _ = profiled(eager)
    finally:
        ex.close()
        eager.close()

    # the coded GEMMs' launches: the device's kernel instances, since no
    # wrapper runs in a replay (and none ran: no eager fallback)
    counts = {"piece_gemm_stacked": sum(r["calls"]
                                        for r in profile["piece_rows"]),
              "skinny_gemm": sum(r["calls"] for r in profile["coding_rows"])}
    counts.update({k: n for k, n in wrappers.items()
                   if k.startswith("ssd_chunk")})
    require(wrappers["piece_gemm_stacked"] == wrappers["skinny_gemm"]
            == wrappers["conv2d"] == 0,
            f"a replayed run called kernel wrappers: {wrappers}")
    require(runs2 == want["coded_runs"],
            f"{runs2} coded runs in the profiled run")
    for k, n in counts.items():
        design = want["launches_replayed_run"][k.split(".")[0]]
        require(n == design, f"zamba2_mesh profiled run: {n} {k} launches, "
                             f"the design implies {design}")

    # ---- tokens and logits: the threaded phase's and the uncoded model's ---
    by_id = {c.rid: c for c in out}
    threaded = {c.rid: c for c in z["out"]}
    require(all(np.array_equal(by_id[r].tokens, threaded[r].tokens)
                for r in threaded),
            "the mesh served other tokens than the worker pool")
    quality = hold_to_uncoded("zamba2_mesh", buckets, out, steps, z["refs"])
    max_delta = max(float((got - pool).abs().max())
                    for got, pool in zip(steps, z["steps"]))
    calls = {k: {c: v["runtime_calls"].get(c, {"calls": 0})["calls"]
                 for c in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cudaGraphLaunch", "cudaStreamSynchronize")}
             for k, v in (("mesh", profile), ("mesh_eager", eager_profile),
                          ("threads", z["threaded"]["profile"]))}
    require(calls["mesh"]["cudaStreamSynchronize"]
            < calls["threads"]["cudaStreamSynchronize"],
            f"runtime calls per generate: {calls}")
    require(calls["mesh"]["cudaGraphLaunch"] == runs2,
            f"{calls['mesh']['cudaGraphLaunch']} graph launches in {runs2} "
            "coded runs")
    require(calls["mesh_eager"]["cudaGraphLaunch"] == 0,
            "the eager yardstick replayed a graph")
    ttft, own, per_tok = latency_rows(buckets, by_id)
    head = turns[0]
    emit({"phase": "zamba2_mesh",
          "executor": "MeshExecutor(dead=(1,), stragglers=(2,)): one CUDA "
                      "graph per (token count, weight), replayed per run",
          "coded": {"scheme": "mds", "n": N_WORKERS, "k": ZAMBA2_K},
          "reference": "the zamba2 phase's tokens and per-step logits (worker "
                       "pool), and its uncoded teacher-forced logits",
          "first_run": {"note": "captures every graph",
                        "wall_s": wall_s, "tokens_per_s": n_tokens / wall_s,
                        "ttft_ms": ttft, "ttft_own_bucket_ms": own,
                        "decode_ms_per_token": per_tok},
          "wall_s": head["wall_s"], "tokens": n_tokens,
          "tokens_per_s": head["tokens_per_s"], "ttft_ms": head["ttft_ms"],
          "ttft_own_bucket_ms": head["ttft_own_bucket_ms"],
          "decode_ms_per_token": head["decode_ms_per_token"],
          "run_wall_ms": head["run_wall_ms"],
          "turns": turns,
          "turns_note": "the same requests, every graph captured: 'graph' "
                        "replays, 'eager' runs the same program on every "
                        "call (MeshExecutor.program, no graph)",
          "built": built, "built_expected": {
              k: want[k] for k in ("programs", "graphs", "coded_runs")},
          "wrapper_calls_first_run": first_calls,
          "launches": counts,
          "launches_note": "the profiled run: coded GEMMs as device kernel "
                           "instances (piece_*, coding_gemm_* rows), the SSD "
                           "as wrapper launches",
          "launches_expected": want,
          "tokens_equal_threaded": n_tokens, **quality,
          "max_abs_logit_delta_vs_threaded": max_delta,
          "runtime_calls_per_generate": calls,
          "threaded": z["threaded"], "profile": profile,
          "eager_profile": eager_profile})
    return counts


# ---------------------------------------------------------------------------
# phase 7: the adaptive loop — re-planning, drift forensics, autoscaling
# ---------------------------------------------------------------------------

ADAPTIVE_PROBE_EVERY = 3   # every 3rd coded run gathers all pieces
ADAPTIVE_MIN_SAMPLES = 4   # observations before a worker's profile is used
VGG_DRIFT_AT, VGG_DRIFT_WORKER, VGG_DRIFT = 6, 4, 8.0
VGG_REQUESTS = 12
# the autoscaler's scripted queue depths and the decisions they give,
# (t, joined, drained, n_alive); tests/test_torch_autoscale.py pins the same
AUTOSCALE_SERIES = (0, 8, 16, 16, 4, 0, 0, 0, 0, 0)
AUTOSCALE_PINNED = [
    (0.0, (), (9,), 9), (1.0, (), (), 9), (2.0, (), (), 9),
    (3.0, (10, 11, 12), (), 12), (4.0, (), (), 12), (5.0, (), (), 12),
    (6.0, (), (), 12), (7.0, (), (), 12), (8.0, (), (), 12),
    (9.0, (), (12,), 11)]


class LaunchTally:
    """Counts the skinny GEMM's launches by (regime, variant, m, b, F)
    while active, by wrapping the module's ``_launch`` (every wrapper's
    launch goes through it).  A breakdown of ``skinny_gemm.launches``,
    which stays the count the kernels line reports."""

    def __init__(self):
        import collections
        import threading

        self.counts = collections.Counter()
        self._lock = threading.Lock()

    def __enter__(self):
        import repro_torch.kernels.skinny_gemm as sg

        self._orig = orig = sg._launch

        def counting(A, X, plan):
            out = orig(A, X, plan)
            with self._lock:
                self.counts[(plan.regime, plan.variant, A.shape[0],
                             A.shape[1], X.shape[1])] += 1
            return out

        sg._launch = counting
        return self

    def __exit__(self, *exc):
        import repro_torch.kernels.skinny_gemm as sg

        sg._launch = self._orig


def gemm_key(torch, m: int, b: int, F: int) -> tuple:
    """The tally key the launch plan of ``(m, b) @ (b, F)`` (f32, aligned)
    gives."""
    from repro_torch.kernels.skinny_gemm import piece_plan

    plan = piece_plan(m, b, F, torch.float32, True)
    return (plan.regime, plan.variant, m, b, F)


def tally_covered(torch, tally: LaunchTally, where: str) -> None:
    """Every launched shape is a ``kernels`` phase case (held there against
    its plain version and f64)."""
    held = set()
    for _, A_src, F, *_ in gemm_cases(torch):
        m, b = A_src if isinstance(A_src, tuple) else A_src.shape
        held.add((m, b, F))
    missing = sorted({k[2:] for k in tally.counts} - held)
    require(not missing, f"{where}: skinny-GEMM shapes no kernels case "
                         f"holds: {missing}")


def tally_rows(tally: LaunchTally) -> list:
    return [{"regime": r, "variant": v, "shape": [m, b, F], "launches": n}
            for (r, v, m, b, F), n in sorted(tally.counts.items())]


def decode_amplification(code, subset) -> float:
    """|D|_inf |G_S|_inf of an MDS decode from ``subset``: how much it
    amplifies the pieces' roundoff (1 for a selection scheme)."""
    import numpy as np

    if not hasattr(code, "decode_matrix"):
        return 1.0
    D = np.abs(code.decode_matrix(subset)).sum(1).max()
    G = np.abs(code.generator[list(subset)]).sum(1).max()
    return float(D * G)


def teacher_forced_refs(torch, cfg, params, reqs, ids, T, new, gen) -> list:
    """The uncoded model's last-position logits at each of a bucket's
    ``new`` served steps, fed the served tokens ``gen`` (b, new)."""
    import numpy as np
    from repro_torch.models import model as M

    toks = torch.as_tensor(np.stack([reqs[j].prompt for j in ids]),
                           device="cuda")
    logits, cache = M.prefill(cfg, params, toks, max_seq=T + new)
    refs = []
    for s in range(new):
        if s:
            nxt = torch.as_tensor(gen[:, s - 1: s], device="cuda")
            logits, cache = M.decode_step(cfg, params, cache, token=nxt)
        refs.append(logits[:, 0, : cfg.vocab])
    return refs


def uncoded_step_refs(torch, z, out) -> list:
    """The uncoded logits of every served step, teacher-forced on ``out``'s
    tokens: the zamba2 phase's where a bucket served the same tokens,
    computed anew where it did not."""
    import numpy as np

    by_id = {c.rid: c for c in out}
    theirs = {c.rid: c for c in z["out"]}
    refs, i = [], 0
    for ids, T, new in z["buckets"]:
        if all(np.array_equal(by_id[j].tokens, theirs[j].tokens)
               for j in ids):
            refs += z["refs"][i:i + new]
        else:
            refs += teacher_forced_refs(
                torch, z["cfg"], z["params"], z["reqs"], ids, T, new,
                np.stack([by_id[j].tokens for j in ids]))
        i += new
    return refs


def hold_to_uncoded(label, buckets, out, steps, refs) -> dict:
    """Logits within 1e-3 max|logit| of the uncoded model's at every step;
    tokens the argmax of the served logits, and the uncoded argmax outside
    near-ties (a top-2 margin within the tolerance)."""
    by_id = {c.rid: c for c in out}
    worst, near_ties, checked, i = 0.0, 0, 0, 0
    import numpy as np

    for ids, T, new in buckets:
        gen = np.stack([by_id[j].tokens for j in ids])
        for s in range(new):
            ref, got = refs[i], steps[i]
            tol = 1e-3 * float(ref.abs().max())
            err = float((got - ref).abs().max())
            require(err <= tol, f"{label} bucket T={T} step {s}: logits "
                                f"differ from the uncoded model by {err} > "
                                f"{tol}")
            worst = max(worst, err / tol)
            require(bool((got.argmax(-1).cpu().numpy() == gen[:, s]).all()),
                    f"{label}: served tokens are not the argmax of their "
                    "logits")
            top2 = ref.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            agree = ref.argmax(-1).cpu().numpy() == gen[:, s]
            require(bool(agree[margin > tol].all()),
                    f"{label} bucket T={T} step {s}: a token differs from "
                    "the uncoded one outside a near-tie")
            near_ties += int((margin <= tol).sum())
            checked += int((margin > tol).sum())
            i += 1
    require(i == len(steps), f"{label}: {len(steps)} recorded steps, {i} "
                             "checked")
    return {"steps_checked": i, "tokens_checked": checked,
            "near_ties": near_ties, "worst_logit_err_over_tol": worst}


def adaptive_zamba2(torch, z) -> tuple:
    """(a) Zamba2-1.2B served by ``Engine(adaptive=True)`` on the zamba2
    phase's pool (dead worker 1, 50x straggler 2, FakeClock): every coded
    GEMM re-solves (k, assignment) from the live profiles."""
    import collections

    import numpy as np
    from repro_torch.dist import AdaptiveExecutor, FakeClock
    from repro_torch.serving import Engine

    cfg, params, reqs, buckets = z["cfg"], z["params"], z["reqs"], z["buckets"]
    dead, straggler = 1, 2

    def serve(profiled: bool) -> dict:
        ex = make_executor(FakeClock())
        try:
            eng = Engine(cfg, params, coded=(N_WORKERS, ZAMBA2_K),
                         scheme="mds", executor=ex, adaptive=True)
            ad = eng.executor
            require(isinstance(ad, AdaptiveExecutor) and ad.pool is ex.pool,
                    "adaptive=True did not wrap the caller's pool")
            ad.probe_every = ADAPTIVE_PROBE_EVERY
            ad.planner.bank.min_samples = ADAPTIVE_MIN_SAMPLES
            steps = record_steps(eng)
            runs = []
            plan_matmul = ad.plan_matmul

            def recording(scheme, name, tokens, d_in, d_out):
                got = plan_matmul(scheme, name, tokens, d_in, d_out)
                runs.append({"tokens": tokens, "d_in": d_in,
                             "d_out": d_out, "planned": got})
                return got

            def on_report(r):
                require("report" not in runs[-1], "a coded run without a "
                                                  "plan_matmul call")
                runs[-1].update(report=r, probe=ad.last_was_probe)

            ad.plan_matmul = recording
            ad.on_report = on_report
            prof = None
            if profiled:
                from torch.profiler import ProfilerActivity, profile as tprof
                prof = tprof(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
                prof.__enter__()
            torch.cuda.synchronize()
            zero_launch_counters()
            with LaunchTally() as tally:
                t0 = time.perf_counter()
                out = eng.generate(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = read_launch_counters()
            profile = None
            if prof is not None:
                prof.__exit__(None, None, None)
                profile = device_time_of(prof)
                profile["wall_ms"] = wall * 1e3
                profile["idle_share"] = max(
                    0.0, 1.0 - profile["device_ms"] / (wall * 1e3))
                profile["coding_rows"] = coding_rows(prof, "adaptive")
            require(all("report" in r for r in runs),
                    "a plan_matmul call without a coded run")
            return {"out": out, "steps": steps, "runs": runs, "wall": wall,
                    "tally": tally, "counts": counts, "profile": profile,
                    "ready": ad.planner.ready,
                    "speeds": ad.planner.speeds(N_WORKERS)}
        finally:
            ex.close()

    first = serve(profiled=False)
    again = serve(profiled=True)
    runs = first["runs"]

    def nk(r):
        n_new, k_new, _ = r["planned"]
        return (n_new if n_new is not None else N_WORKERS,
                k_new if k_new is not None else ZAMBA2_K)

    def trail(rs):
        return [(r["tokens"], r["d_in"], nk(r), r["planned"][2],
                 sorted(r["report"].assignment.items()),
                 r["report"].subset) for r in rs]

    # the plans are a function of the virtual clock's telemetry alone
    require(trail(again["runs"]) == trail(runs),
            "a second adaptive run made other plans")
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(first["out"], again["out"])),
            "two adaptive runs of the same requests gave other tokens")
    require(first["ready"], "the planner's profiles never became ready")
    hist = collections.Counter()
    want = collections.Counter()
    for r in runs:
        rep = r["report"]
        n, k = nk(r)
        require(len(rep.assignment) == n and len(rep.subset) == k,
                f"a run of {len(rep.assignment)} pieces decoding "
                f"{len(rep.subset)}, planned ({n}, {k})")
        require(all(rep.assignment[p] != dead for p in rep.subset),
                f"a consumed piece came from the dead worker: {rep.subset}")
        hist[(r["tokens"], n, k)] += 1
        t_p = r["tokens"] // k
        want[gemm_key(torch, n, k, t_p * r["d_in"])] += 1
        want[gemm_key(torch, t_p, r["d_in"], r["d_out"])] += sum(
            1 for w in rep.assignment.values() if w != dead)
        want[gemm_key(torch, k, k, t_p * r["d_out"])] += 1
    require((8, N_WORKERS, 7) in hist,
            f"no B = 8 decode GEMM ran at (10, 7): {dict(hist)}")
    tally = first["tally"]
    require(tally.counts == want,
            f"skinny-GEMM launches by (regime, variant, shape) "
            f"{dict(tally.counts)}, the design implies {dict(want)}")
    counts = first["counts"]
    require(sum(tally.counts.values()) == counts["skinny_gemm"],
            "the tally and the wrapper's count disagree")
    tally_covered(torch, tally, "adaptive zamba2")
    n_ssd = cfg.n_layers * len(buckets)
    for key, n in counts.items():
        if key.startswith("ssd_chunk"):
            require(n == n_ssd, f"{n} {key} launches, the design implies "
                                f"{n_ssd}")
    require(counts["conv2d"] == 0 and counts["piece_gemm_stacked"] == 0,
            f"kernels off the path launched: {counts}")
    last = [r for r in runs if not r["probe"]][-1]["report"]
    require(straggler not in last.assignment.values(),
            f"the 50x straggler still holds pieces once the profiles are "
            f"ready: {last.assignment}")
    pieces = collections.Counter(w for r in runs
                                 for w in r["report"].assignment.values())
    by_id = {c.rid: c for c in first["out"]}
    ttft, own, per_tok = latency_rows(buckets, by_id)
    quality = hold_to_uncoded("adaptive", buckets, first["out"],
                              first["steps"],
                              uncoded_step_refs(torch, z, first["out"]))
    same = sum(np.array_equal(c.tokens, d.tokens)
               for c, d in zip(first["out"], z["out"]))
    virtual = sum(r["report"].t_complete for r in runs)
    # a probe waits for every piece: its honest completion is the last
    # arrival, not the k-th
    waited = sum((max(a.t for a in r["report"].arrivals) if r["probe"]
                  else r["report"].t_complete) for r in runs)
    static = z["threaded"]
    out = {
        "setup": "Engine(coded=(10, 6), scheme='mds', executor=make_executor("
                 "FakeClock()), adaptive=True), probe_every "
                 f"{ADAPTIVE_PROBE_EVERY}, min_samples {ADAPTIVE_MIN_SAMPLES}",
        "adaptive": {
            "wall_s": first["wall"], "ttft_ms": ttft,
            "ttft_own_bucket_ms": own, "decode_ms_per_token": per_tok,
            "coded_runs": len(runs),
            "probes": sum(1 for r in runs if r["probe"]),
            "virtual_completion_s": virtual,
            "virtual_completion_with_probe_waits_s": waited,
            "nk_histogram": [[t, n, k, c] for (t, n, k), c in
                             sorted(hist.items())],
            "pieces_per_worker": {str(w): pieces[w]
                                  for w in range(N_WORKERS)},
            "last_assignment": sorted(last.assignment.items()),
            "speeds": first["speeds"],
            "launches": counts,
            "skinny_gemm_by_plan": tally_rows(tally),
            "profiled_run": again["profile"],
            "requests_with_the_static_tokens": int(same), **quality},
        "static": {
            "wall_s": static["wall_s"], "ttft_ms": static["ttft_ms"],
            "decode_ms_per_token": static["decode_ms_per_token"],
            "coded_runs": static["coded_runs"],
            "virtual_completion_s": static["virtual_completion_s"],
            "nk": [N_WORKERS, ZAMBA2_K],
            "device_ms": static["profile"]["device_ms"],
            "idle_share": static["profile"]["idle_share"]}}
    return out, counts


def adaptive_vgg16(torch) -> tuple:
    """(b) VGG16 at 224x224 on an ``AdaptiveExecutor`` whose worker 4
    becomes an 8x straggler from request 6 on; the explainer names it, the
    regime detector dates it, and the planner re-plans after a reset."""
    import numpy as np
    from repro_torch.core import SystemParams, compile_plan
    from repro_torch.core.netplan import SegmentStep
    from repro_torch.dist import (AdaptiveExecutor, AdaptivePlanner,
                                  DeterministicDelay, FakeClock, FaultPlan,
                                  StragglerDrift)
    from repro_torch.kernels.conv2d import conv2d as conv_kernel
    from repro_torch.kernels.skinny_gemm import skinny_gemm
    from repro_torch.models.cnn import (init_vgg16, vgg16_conv_specs,
                                        vgg16_forward)
    from repro_torch.telemetry import (TraceRecorder, detect_regimes,
                                       explain_breaches,
                                       features_from_report)

    class StampedPlanner(AdaptivePlanner):
        """Stamps every observation with the request it came from, so that
        ``reset_at(request)`` drops exactly the samples before it."""

        now = 0.0

        def observe_report(self, report, sizes, *, at=None, layer_ids=None):
            return super().observe_report(
                report, sizes, at=self.now if at is None else at,
                layer_ids=layer_ids)

    image, n_classes = 224, 1000
    layers = vgg16_conv_specs(image)
    plan = compile_plan(layers, N_WORKERS, SystemParams(), "mds")
    params = init_vgg16(torch.Generator(device="cuda").manual_seed(SEED),
                        n_classes=n_classes, image=image)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    total = VGG_REQUESTS + 2
    xs = [torch.randn((1, 3, image, image), generator=gen, device="cuda")
          for _ in range(total)]
    wants = [vgg16_uncoded_plain(torch, layers, params, x) for x in xs]
    planner = StampedPlanner()
    ex = AdaptiveExecutor(N_WORKERS, planner=planner, clock=FakeClock(),
                          delay_model=DeterministicDelay(1.0),
                          probe_every=4)
    sink = TraceRecorder()
    ex.trace_sink = sink
    ex.pool.trace_sink = sink
    drift = StragglerDrift(((VGG_DRIFT_AT, FaultPlan(
        straggler={VGG_DRIFT_WORKER: VGG_DRIFT})),))
    requests = []

    def serve(i, plan):
        planner.now = float(i)
        ex.pool.fault_plan = drift.plan_at(i)
        reps = []
        ex.on_report = lambda r: reps.append((r, ex.last_was_probe))
        g0, c0 = skinny_gemm.launches, conv_kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = vgg16_forward(params, xs[i], plan=plan, executor=ex)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ex.on_report = None
        segs = [s for s in plan.steps if isinstance(s, SegmentStep)]
        require(len(reps) == len(segs), f"{len(reps)} runs, {len(segs)} "
                                        "segments")
        ref = wants[i]
        # f32 roundoff through the network, amplified by each decode: the
        # vgg16 phase's 1e-3 max|logit| at its subsets' |D| |G_S| of 488,
        # scaled by the worst amplification of this request's subsets (a
        # fault-free fleet's ties decode from {0..5}: 7177)
        amp = max(decode_amplification(seg.scheme, r.subset)
                  for (r, _), seg in zip(reps, segs))
        tol = 1e-3 / 488.0 * max(amp, 488.0) * float(ref.abs().max())
        err = float((logits - ref).abs().max())
        require(tuple(logits.shape) == (1, n_classes)
                and bool(torch.isfinite(logits).all()),
                f"vgg16 drift request {i}: shape or non-finite")
        require(err <= tol, f"vgg16 drift request {i}: logits differ, "
                            f"{err} > {tol}")
        require(bool((logits.argmax(-1) == ref.argmax(-1)).all()),
                f"vgg16 drift request {i}: argmax differs")
        n_local = sum(s.stop - s.start for s in plan.steps
                      if not isinstance(s, SegmentStep))
        # every piece is computed on the virtual clock (no dead worker)
        want_conv = n_local + sum(len(r.assignment) for r, _ in reps) + sum(
            1 for s in segs if s.split.remainder is not None)
        dc = conv_kernel.launches - c0
        dg = skinny_gemm.launches - g0
        require(dc == want_conv and dg == 2 * len(segs),
                f"vgg16 drift request {i}: {dc} conv, {dg} skinny-GEMM "
                f"launches, the plan implies {want_conv}, {2 * len(segs)}")
        completion = sum(
            (max(a.t for a in r.arrivals) if probe else r.t_complete)
            - r.t_submit for r, probe in reps)
        row = {}
        for r, _ in reps:
            for key, v in features_from_report(r, per_layer=True).items():
                row[key] = max(row.get(key, v), v)
        requests.append({"request": i, "wall_ms": wall_ms,
                         "max_abs_err": err, "tol": tol,
                         "decode_amplification": amp,
                         "virtual_completion_s": completion,
                         "probes": sum(1 for _, p in reps if p),
                         "segments": len(segs), "conv2d_launches": dc,
                         "skinny_gemm_launches": dg})
        return completion, row

    zero_launch_counters()
    try:
        done = [serve(i, plan) for i in range(VGG_REQUESTS)]
        comps = [c for c, _ in done]
        med = float(np.median(comps[:VGG_DRIFT_AT]))
        breach = [c > 1.5 * med for c in comps]
        times = [float(i) for i in range(VGG_REQUESTS)]
        report = explain_breaches([r for _, r in done], breach, times)
        require(bool(report.culprits)
                and report.culprits[0].worker == VGG_DRIFT_WORKER,
                f"the explainer did not rank worker {VGG_DRIFT_WORKER} "
                f"first: {report.describe()}")
        split = detect_regimes(comps)
        require(split is not None and abs(split.split - VGG_DRIFT_AT) <= 1,
                f"regime shift found at {split}, drift at {VGG_DRIFT_AT}")
        planner.reset_at(float(split.split))
        replan = planner.replan_segments(layers, N_WORKERS)
        for i in range(VGG_REQUESTS, total):
            serve(i, replan)
        counts = read_launch_counters()
    finally:
        ex.close()
    require(counts["conv2d"] > 0 and counts["skinny_gemm"] > 0,
            f"a kernel of the path was never launched: {counts}")
    return {"setup": "vgg16_forward(executor=AdaptiveExecutor(10, FakeClock,"
                     " DeterministicDelay(1.0), probe_every=4)), worker "
                     f"{VGG_DRIFT_WORKER} {VGG_DRIFT}x from request "
                     f"{VGG_DRIFT_AT}",
            "breach_rule": "virtual completion > 1.5 x median of requests "
                           f"0-{VGG_DRIFT_AT - 1} ({med})",
            "breaches": breach, "explainer": json.loads(report.to_json()),
            "explainer_says": report.describe(),
            "regime": {"split": split.split, "mean_pre": split.mean_pre,
                       "mean_post": split.mean_post, "score": split.score},
            "plan": plan.describe(), "replan": replan.describe(),
            "replan_changed": replan.describe() != plan.describe(),
            "speeds": planner.speeds(N_WORKERS),
            "trace": {"run_spans": len(sink.by_name("run")),
                      "piece_spans": len(sink.by_name("piece"))},
            "launches": counts, "requests": requests}, {
        k: counts[k] for k in ("skinny_gemm", "conv2d")}


def adaptive_autoscale(torch) -> dict:
    """(c) An elastic pool under ``Autoscaler(min 6, max 12)``, stepped
    through a scripted queue-depth series, with the decode-step GEMM
    (8, 2048) @ (2048, 8192) coded over the live fleet after each step."""
    from repro_torch.core import coded_matmul
    from repro_torch.core.schemes import get_scheme
    from repro_torch.dist import (Autoscaler, CodedExecutor,
                                  DeterministicDelay, FakeClock)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    T, d_in, d_out = 8, 2048, 8192
    x = _rand(torch, gen, (T, d_in), torch.float32)
    w = _rand(torch, gen, (d_in, d_out), torch.float32, d_in ** -0.5)
    exact = x.double() @ w.double()
    base = get_scheme("mds").make(N_WORKERS, ZAMBA2_K)
    ex = CodedExecutor(N_WORKERS, clock=FakeClock(),
                       delay_model=DeterministicDelay(1.0), elastic=True)
    rows, got = [], []
    try:
        auto = Autoscaler(ex.pool, min_workers=6, max_workers=12)
        with LaunchTally() as tally:
            for i, q in enumerate(AUTOSCALE_SERIES):
                dec = auto.step(q, float(i))
                got.append((dec.t, dec.joined, dec.drained, dec.n_alive))
                n_new, k_new, _ = ex.plan_matmul(base, "mds", T, d_in, d_out)
                n = n_new if n_new is not None else base.n
                k_policy = k_new if k_new is not None else base.k
                # the policy's k (n - 2) outgrows the 8 tokens at n >= 11:
                # the step is split into at most 8 token pieces
                code = get_scheme("mds").make(n, min(k_policy, T))
                y = coded_matmul(x, w, code, executor=ex)
                torch.cuda.synchronize()
                rep = ex.last_report
                # coded vs exact: the pieces' f32 roundoff of a length-d_in
                # sum (~sqrt(d_in) u) amplified by the decode, 4x slack
                tol = (4.0 * decode_amplification(code, rep.subset)
                       * d_in ** 0.5 * 2.0 ** -24 * float(exact.abs().max()))
                err = float((y.double() - exact).abs().max())
                require(n == dec.n_alive, f"autoscale step {i}: n = {n}, "
                                          f"{dec.n_alive} alive")
                require(sorted(set(rep.assignment.values()))
                        == ex.pool.dispatch_preview(),
                        f"autoscale step {i}: pieces went to "
                        f"{sorted(set(rep.assignment.values()))}, the "
                        f"fleet is {ex.pool.dispatch_preview()}")
                require(err <= tol, f"autoscale step {i}: coded GEMM err "
                                    f"{err} > {tol}")
                rows.append({"step": i, "queue": q, "decision": {
                    "joined": dec.joined, "drained": dec.drained,
                    "n_alive": dec.n_alive, "reason": dec.reason},
                    "n": n, "k_policy": k_policy, "k": code.k,
                    "subset": rep.subset, "max_abs_err": err, "tol": tol})
    finally:
        ex.close()
    require(got == AUTOSCALE_PINNED,
            f"autoscaler decisions {got}, pinned {AUTOSCALE_PINNED}")
    tally_covered(torch, tally, "autoscale")
    return {"setup": "CodedExecutor(10, FakeClock, DeterministicDelay(1.0), "
                     "elastic=True), Autoscaler(min_workers=6, "
                     "max_workers=12)",
            "series": AUTOSCALE_SERIES, "steps": rows,
            "skinny_gemm_by_plan": tally_rows(tally)}


def adaptive_mesh_spans(torch, z) -> dict:
    """(d) The zamba2_mesh phase's executor with a ``TraceRecorder``: one
    real-clock "run" span per coded op, whose sum per ``generate`` is the
    host time spent inside coded runs."""
    import numpy as np
    from repro_torch.dist import MeshExecutor
    from repro_torch.serving import Engine
    from repro_torch.telemetry import TraceRecorder

    cfg, params, reqs = z["cfg"], z["params"], z["reqs"]
    want_runs = zamba2_mesh_expected(cfg)["coded_runs"]
    mx = MeshExecutor(dead=(1,), stragglers=(2,))
    sink = TraceRecorder()
    mx.trace_sink = sink
    rows = []
    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, ZAMBA2_K), executor=mx)
        for label in ("first (captures every graph)", "replays",
                      "replays"):
            sink.clear()
            r0 = mx.run_count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            spans = sink.by_name("run")
            require(len(spans) == mx.run_count - r0 == want_runs,
                    f"{len(spans)} run spans for {mx.run_count - r0} coded "
                    f"ops, the design implies {want_runs}")
            require(all(s.tid == "mesh" for s in spans), "a span off the "
                                                         "mesh track")
            require(all(np.array_equal(a.tokens, b.tokens)
                        for a, b in zip(out, z["out"])),
                    "the traced mesh served other tokens than the pool")
            span_s = sum(s.dur for s in spans)
            rows.append({"generate": label, "wall_s": wall,
                         "run_spans": len(spans), "run_span_sum_s": span_s,
                         "share_of_wall": span_s / wall,
                         "run_span_ms": t_compute_stats(
                             [s.dur for s in spans])})
    finally:
        mx.close()
    return {"setup": "MeshExecutor(dead=(1,), stragglers=(2,)) with a "
                     "TraceRecorder as trace_sink",
            "generates": rows}


def phase_adaptive(torch, z: dict) -> dict:
    """Parts (a) to (d), one JSON line each; returns the counted paths'
    launches."""
    zamba2, counts_a = adaptive_zamba2(torch, z)
    emit({"phase": "adaptive", "part": "a: zamba2", **zamba2})
    vgg16, counts_b = adaptive_vgg16(torch)
    emit({"phase": "adaptive", "part": "b: vgg16 drift", **vgg16})
    emit({"phase": "adaptive", "part": "c: autoscale",
          **adaptive_autoscale(torch)})
    emit({"phase": "adaptive", "part": "d: mesh host spans",
          **adaptive_mesh_spans(torch, z)})
    return {"adaptive_zamba2": counts_a, "adaptive_vgg16": counts_b}


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
# the one-program backend's entry of the skinny GEMM: all n pieces of a run
KERNEL_META["piece_gemm_stacked"] = dict(KERNEL_META["skinny_gemm"])
# the SSD kernel's four passes, each a kernel of the same source
KERNEL_META.update({
    f"ssd_chunk.{p}": dict(KERNEL_META["ssd_chunk"])
    for p in ("cb", "states", "state_pass", "out")})


def kernels_line(cases: list[dict], by_path: dict) -> dict:
    """One entry per kernel: ``launches`` sums the main paths' counted runs
    (``launches_by_path`` splits them; on ``zamba2_mesh`` the coded GEMMs'
    are the profiled run's device kernel instances, since a graph replay
    calls no wrapper), the numbers are the headline case's,
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
            **({"bound_3xtf32_ms": head["bound_3xtf32_ms"]}
               if "bound_3xtf32_ms" in head else {}),
            "cases_checked": len(mine),
            "worst_err_over_tol": max(c["err_over_tol"] for c in mine)})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--time-kernels", metavar="CHECKOUT",
                    help="only time the skinny GEMM, the conv and the SSD "
                         "scan of the port under CHECKOUT/src at this "
                         "script's f32 cases (one JSON line, no result line)")
    args = ap.parse_args()
    if args.time_kernels:
        sys.path.insert(0, os.path.join(os.path.abspath(args.time_kernels),
                                        "src"))
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES:
            ap.error(f"unknown phase {p!r}")
    for p in ("zamba2_mesh", "adaptive"):
        if p in phases and "zamba2" not in phases:
            ap.error(f"{p} is held against the zamba2 phase: run both")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    if args.time_kernels:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        time_kernels(torch, args.time_kernels)
        return 0

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
        by_path["zamba2"], zamba2 = phase_zamba2(torch)
    if "zamba2_mesh" in phases:
        by_path["zamba2_mesh"] = phase_zamba2_mesh(torch, zamba2)
    if "adaptive" in phases:
        by_path.update(phase_adaptive(torch, zamba2))

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
