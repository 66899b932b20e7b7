#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/``), and then, phase by phase, each printing JSON lines:

1. ``device``    — card name and power limit (``nvidia-smi``), torch and CUDA
                   versions, kernel build seconds.
2. ``kernels``   — every ported kernel against its plain PyTorch version on
                   the card, at the shapes the VGG16 path gives it and at
                   the edge shapes (ragged F, C_O = 7, K in {1, 5, 7}, stride
                   2, width slices, bf16), with times, bounds and the
                   library yardstick (``torch.matmul`` / ``F.conv2d``, TF32
                   off — timed here, never called by the port).
3. ``coded_ops`` — ``coded_conv2d`` and ``coded_matmul`` through a
                   ``CodedExecutor`` with one dead worker and one straggler,
                   against the uncoded result.
4. ``vgg16``     — the main path: VGG16 at 224x224, f32, seeded random
                   weights, served through ``vgg16_forward`` on a worker pool
                   (requests of batch 1, 4, 1 on the virtual clock, two
                   more under torch.profiler, one on the real clock),
                   logits held against the
                   same network run uncoded through ``F.conv2d``; launch
                   counters prove the kernels carried the path.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  There is no fallback: no GPU, a kernel
that does not build or launch, or any failed check ends the run with a
non-zero exit code and no result line.

``--phases kernels,vgg16`` runs a subset (for debugging; the result line is
only printed when every phase ran).
"""
from __future__ import annotations

import argparse
import json
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
ALL_PHASES = ("device", "kernels", "coded_ops", "vgg16")


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


def phase_kernels(torch) -> list[dict]:
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [check_gemm(torch, timer, gen, *c) for c in gemm_cases(torch)]
    cases += [check_conv(torch, timer, gen, *c) for c in conv_cases(torch)]
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with boundary_op_counter() as ops:
            logits = vgg16_forward(params, xb, plan=plan, executor=ex)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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

KERNEL_META = {
    "skinny_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/skinny_gemm.cu",
        "replaces": "src/repro/kernels/mds_encode.py:57"},
    "conv2d": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d.py:67"},
}


def kernels_line(cases: list[dict], counts: dict) -> dict:
    out = []
    for name, meta in KERNEL_META.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["headline"])
        out.append({
            "name": name, **meta, "launches": counts[name],
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
    counts = phase_vgg16(torch) if "vgg16" in phases else None

    if set(phases) != set(ALL_PHASES):
        print(f"partial run ({phases}): no result line", file=sys.stderr)
        return 0
    emit(kernels_line(cases, counts))
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
