#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/``), and then, phase by phase, each printing JSON lines:

1. ``device``    — card name and power limit (``nvidia-smi``), torch and CUDA
                   versions, kernel build seconds, and TF32 ``mma.sync``'s
                   rate and latency on this card (``csrc/mma_probe.cu``).
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
                   timed beside a device copy of the same bytes.  The SSD
                   backward (``ssd_chunk_scan_bwd``, four reversed passes
                   in 3xTF32, the heads' shares of dG, dB and dC summed on
                   chip in groups of ``bwd_heads``) at the Zamba2 train
                   shape (B 4, T 512), with h0 and the final state's
                   gradient, a ragged chunk, Mamba2-2.7B's heads, bf16 and
                   odd widths, and each reversed pass alone, against its
                   plain version and f64, two runs bit for bit, each with
                   its bound at the f32 SIMT rate and at the 3xTF32 rate.
3. ``coded_ops`` — ``coded_conv2d`` and ``coded_matmul`` through a
                   ``CodedExecutor`` with one dead worker and one straggler,
                   against the uncoded result; the same ops on a
                   ``MeshExecutor`` with the same faults, bit for bit equal
                   to the pool's, a graph replay equal to the eager program,
                   and every scheme x fault x op at small shapes.
3a. ``mesh_async`` — ``MeshExecutor`` does not wait for its runs: a
                   prefill-sized coded matmul, (1797 x 2048) @ (2048 x
                   8192), MDS (10, 6), dead 1, straggler 2.  The stream is
                   still busy when ``run_op`` returns; the result is bit
                   for bit the same run followed by a synchronise, and
                   within the decode's roundoff of the uncoded product;
                   ``settle()`` delivers one report a run, each with its
                   time on the card; a shared block's three FFN runs issued
                   back to back count ``queued_runs`` >= 2; a run on
                   another stream is refused.
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

8. ``serving``   — serving under load through ``ServingScheduler.serve``:
                   (a) gemma-2b at full width (18 layers, d_model 2048,
                   MQA, geglu d_ff 16384, vocab 256000), f32, seeded random
                   weights, coded (10, 6) on the zamba2 phase's pool, 32
                   Poisson arrivals in virtual time with prompts of 4
                   shared 256-token prefixes and 16-256-token suffixes,
                   served in four arms: grouped by length, packed, packed
                   with 256-token chunks, and chunked with a prefix cache.
                   Tokens equal across arms and to the uncoded model on 8
                   of the requests (outside near-ties); one coded run per
                   GEMM for a whole packed admission; chunk calls of 54
                   runs each; prefix hits that cut runs and dispatches;
                   every skinny-GEMM launch by (regime, variant, shape)
                   against the design of the coded ops; TTFT, TPOT and e2e
                   on the virtual clock and the wall; device ms and idle
                   share from a profiled serve of each arm.  (b) Zamba2-1.2B
                   on the zamba2 phase's weights through the scheduler's
                   grouped path, tokens equal to ``Engine.generate``'s, 38
                   SSD launches per prefill group.  (c) the packed arm on
                   ``MeshExecutor(dead=(1,), stragglers=(2,))`` in f32 and
                   with bf16 parameters: tokens equal to the pool's, one
                   graph per (program, weight), a second serve that
                   captures nothing and calls no kernel wrapper.
9. ``families``  — the remaining model families, after releasing every
                   earlier phase's model: (a) internvl2-1b and (b)
                   musicgen-medium at published widths and depth, f32,
                   prefilled from ``models.frontends``' synthetic patch
                   (8 x 256) and frame (8 x 500) embeddings, then 16
                   greedy decode steps, coded (10, 6) on the pool and on
                   the mesh with the zamba2 faults, and uncoded: logits
                   within 1e-3 max|logit| of the uncoded model, tokens
                   equal outside near-ties, the mesh's tokens and logits
                   the pool's bit for bit, coded runs and skinny-GEMM
                   launches by regime and shape against the design; (a)
                   also serves 8 token prompts of 512 through
                   ``Engine.generate`` on both backends.  (c) dbrx-132b
                   at published widths, depth 2, f32, and (d)
                   kimi-k2-1t-a32b at published widths, depth 1, bf16,
                   each serving 4 prompts of 512 tokens: ``_moe_ffn``
                   against an f64 mixture of the kept slots, drops per
                   call; (c) also coded (10, 6) with zero coded runs (the
                   reference codes no MoE GEMM), prefill + decode against
                   ``forward`` at capacity 4.0, and the flash forward
                   against the blockwise one; (d) peaks under 45 GB.
10. ``train``    — training through the SSD backward kernel: (a) Zamba2-1.2B
                   at published widths, depth 6 (the shared block after
                   layer 5), f32, B 2 x T 512 from ``TokenStream``: one
                   gradient on the kernels against the f64 gradient of the
                   plain versions, leaf by leaf, no leaf zero, 6 SSD
                   forward and 6 backward launches; (c) its params and
                   AdamW state after one step, and a bf16 leaf, saved and
                   loaded back bit for bit; (b) ``train_loop`` on
                   Zamba2-1.2B at published widths and depth, f32, B 4 x T
                   512, 10 steps: the loss falls, 38 SSD forward and 38
                   backward launches a step, no skinny GEMM, s/step,
                   tokens/s, peak memory and a profiled step; (d) the flash
                   backward at gemma-2b's attention widths against autograd
                   through the blockwise forward, and gemma-2b at published
                   widths, depth 1, differentiated with ``flash_vjp=True``
                   against ``False``, leaf by leaf.

11. ``sharded``  — ``coded_matmul_sharded`` on Zamba2-1.2B's (4096, 2048) @
                   (2048, 8192) and ``coded_conv2d_sharded`` on VGG16's
                   conv2_2 at 224x224, MDS (10, 6), f32: ten spawned
                   processes on the one card in a gloo group (NCCL takes
                   one rank a device), one coded piece a rank.  Rank 0
                   within the ``coded_ops`` err/tol of f64, every rank's y
                   bit for bit rank 0's, two runs bit for bit, each rank's
                   encode, piece and decode launches against the design,
                   wall per op (the ranks time-share the card).
12. ``dryrun``   — on the CPU, in a spawned process started before the
                   first phase and read at the end: ``run_one`` of
                   ``repro_torch.launch.dryrun`` for gemma-2b x decode_32k,
                   zamba2-1.2b x train_4k and zamba2-1.2b x decode_32k on
                   the single-pod mesh (fake
                   process group, fake DTensors), under this machine's
                   torch; and the ``train`` phase's own step counted on a
                   1 x 1 mesh, with its share of the f32 peak and of HBM
                   bandwidth at the s/step the ``train`` phase measured.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  There is no fallback: no GPU, a kernel
that does not build or launch, or any failed check ends the run with a
non-zero exit code and no result line.

``--phases kernels,zamba2`` runs a subset (for debugging; the result line is
only printed when every phase ran; ``zamba2_mesh``, ``adaptive`` and
``serving`` need ``zamba2``; ``families``, ``train``, ``sharded`` and
``dryrun`` stand alone, ``dryrun`` giving the train step's share only when
``train`` ran).
``--time-kernels CHECKOUT`` only times the skinny GEMM, the conv, the SSD
scan and the SSD backward (whole, and each of its kernels from a profile)
of the port in another checkout (a parent commit unpacked beside this one)
at this script's f32 cases, so that two versions can be held against each
other in one run on one card.
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
ALL_PHASES = ("device", "kernels", "coded_ops", "mesh_async", "vgg16",
              "zamba2", "zamba2_mesh", "adaptive", "serving", "families",
              "train", "sharded", "dryrun")


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


def mma_probe(torch) -> dict:
    """TF32 ``mma.sync.m16n8k8`` on this card (``csrc/mma_probe.cu``): the
    rate of 16 warps an SM, 4 independent products each, and one
    product's latency (one warp a sub-partition, one dependent chain),
    from CUDA events around a warmed-up launch."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.load("mma_probe")
    lib.mma_tf32_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.mma_tf32_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(warps, chains, iters):
        require(lib.mma_tf32_probe(out.data_ptr(), sms, warps, chains, 16,
                                   stream) == 0, "mma probe launch")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lib.mma_tf32_probe(out.data_ptr(), sms, warps, chains, iters, stream)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    iters = 4096
    rate = ms(16, 4, iters)
    chain = ms(4, 1, iters)
    return {"tf32_mma_sync_tflops": sms * 16 * 4 * iters * 2048
            / (rate * 1e-3) / 1e12,
            "tf32_mma_sync_latency_ns": chain * 1e6 / iters,
            "sms": sms}


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
           "mma_probe": mma_probe(torch), "ptxas": regs}
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
    ] + serving_gemm_cases(torch, G106, D66) + adaptive_gemm_cases(torch) + \
        family_gemm_cases(torch, G106, D66) + [
        # the headline shape once more, last: two readings show the spread
        ("encode conv2_2 B=1 (again)", G106, 291840, f32, False),
    ]


def serving_gemm_cases(torch, G106, D66) -> list:
    """gemma-2b's coded FFN at (10, 6) (phase ``serving``): w_in / w_gate
    are 2048 -> 16384, w_out 16384 -> 2048.  Packed prefill pieces of 4096
    tokens (t_p = 682), chunk pieces at C = 256 (t_p = 42), decode pieces
    at B = 6..8 (t_p = 1), and their encodes and decodes (the decode
    step's F = 2048 coding shapes are Zamba2's cases already)."""
    f32 = torch.float32
    cases = []
    for t_p, what in ((682, "packed prefill"), (42, "chunk C=256"),
                      (1, "decode")):
        for b, F in GEMMA_FFN:
            cases.append((f"piece GEMM gemma {what} {t_p}x{b}x{F}",
                          (t_p, b), F, f32, False))
        cases += [(f"encode gemma {what} (10,6)@(6,{t_p}*16384)", G106,
                   t_p * 16384, f32, False),
                  (f"decode gemma {what} (6,6)@(6,{t_p}*16384)", D66,
                   t_p * 16384, f32, False)]
        if t_p > 1:
            cases += [(f"encode gemma {what} (10,6)@(6,{t_p}*2048)", G106,
                       t_p * 2048, f32, False),
                      (f"decode gemma {what} (6,6)@(6,{t_p}*2048)", D66,
                       t_p * 2048, f32, False)]
    return cases


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
GEMMA_FFN = ((2048, 16384), (16384, 2048))  # the same for gemma-2b


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
        # the benchmark's batch of 128 images: the master's layers, and each
        # coded layer's piece and remainder slice
        ("conv1_1 master B=128", (128, 3, 226, 226), None, (64, 3, 3, 3), 1, f32, False),
        ("conv1_2 master B=128", (128, 64, 226, 226), None, (64, 64, 3, 3), 1, f32, False),
        ("conv2_1 master B=128", (128, 64, 114, 114), None, (128, 64, 3, 3), 1, f32, False),
        ("conv2_2 piece B=128", (128, 128, 114, 20), None, (128, 128, 3, 3), 1, f32, False),
        ("conv2_2 remainder slice B=128", (128, 128, 114, 114), (108, 114), (128, 128, 3, 3), 1, f32, False),
        ("conv3_1 piece B=128", (128, 128, 58, 11), None, (256, 128, 3, 3), 1, f32, False),
        ("conv3_2 piece B=128", (128, 256, 58, 11), None, (256, 256, 3, 3), 1, f32, False),
        ("conv3_2 remainder slice B=128", (128, 256, 58, 58), (54, 58), (256, 256, 3, 3), 1, f32, False),
        ("conv4_1 piece B=128", (128, 256, 30, 6), None, (512, 256, 3, 3), 1, f32, False),
        ("conv4_2 piece B=128", (128, 512, 30, 6), None, (512, 512, 3, 3), 1, f32, False),
        ("conv4_2 remainder slice B=128", (128, 512, 30, 30), (24, 30), (512, 512, 3, 3), 1, f32, False),
        ("conv5_x piece B=128", (128, 512, 16, 4), None, (512, 512, 3, 3), 1, f32, False),
        ("conv5_x remainder slice B=128", (128, 512, 16, 16), (12, 16), (512, 512, 3, 3), 1, f32, False),
        # edges
        ("C_O=7 K=5 stride 2", (1, 8, 11, 17), None, (7, 8, 5, 5), 2, f32, False),
        ("K=1", (1, 4, 9, 9), None, (64, 4, 1, 1), 1, f32, False),
        ("stride 2", (1, 32, 8, 30), None, (16, 32, 3, 3), 2, f32, False),
        ("K=7 stride 2 (ResNet stem)", (2, 3, 70, 70), None, (64, 3, 7, 7), 2, f32, False),
        ("conv2_2 piece B=1 bf16", (1, 128, 114, 20), None, (128, 128, 3, 3), 1, bf16, False),
        ("conv5_x piece B=4 bf16", (4, 512, 16, 4), None, (512, 512, 3, 3), 1, bf16, False),
        ("C_O=7 K=5 stride 2 bf16", (1, 8, 11, 17), None, (7, 8, 5, 5), 2, bf16, False),
    ]


# Recorded constants, not readings of this run: max |conv - f64| / max |f64|
# at five of the benchmark cell's batch-128 shapes, as the SIMT mainloop
# (plain fmaf) that the tensor-core conv replaced computed it from the same
# inputs (``conv_inputs``) on an NVIDIA H100 80GB HBM3.  The tensor-core conv
# is held within twice it there; every case is held to the f64 convolution
# by ``check_conv``'s own bound.  (Cases with a short contraction, R <= 27,
# read 2-4x the SIMT figure: the 3xTF32 split's own 2^-22 is not small
# beside a sum of a few products.)
SIMT_REL_ERR = {
    "conv1_2 master B=128": 1.115515303219395e-06,
    "conv2_2 piece B=128": 9.086727510274039e-07,
    "conv2_2 remainder slice B=128": 8.254026886189097e-07,
    "conv4_2 piece B=128": 7.25064119403149e-07,
    "conv5_x piece B=128": 5.169113976884719e-07,
}


def conv_inputs(torch, name, xs, sl, ws, dtype):
    """A conv case's (x, w), drawn from a generator of the case's own (the
    seed and the name), so that every run and every checkout timed by
    ``--time-kernels`` computes on the same inputs."""
    import zlib

    gen = torch.Generator(device="cuda").manual_seed(
        SEED * 1_000_003 + zlib.crc32(name.encode()))
    x = _rand(torch, gen, xs, dtype, 0.5)
    if sl is not None:
        x = x[..., sl[0]:sl[1]]  # a width slice, read in place
    w = _rand(torch, gen, ws, dtype, (ws[1] * ws[2] * ws[3]) ** -0.5)
    return x, w


def rel_err_f64(torch, got, x, w, stride) -> float:
    """max |got - conv| / max |conv|, the conv in f64 of the same inputs."""
    import torch.nn.functional as F

    exact = F.conv2d(x.double(), w.double(), stride=stride)
    return float((got.double() - exact).abs().max() / exact.abs().max())


def check_conv(torch, timer, name, xs, sl, ws, stride, dtype,
               headline) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain, conv_plan

    x, w = conv_inputs(torch, name, xs, sl, ws, dtype)
    c_out, c_in, K, _ = ws
    plan = conv_plan(x.shape, ws, stride, dtype)
    got = conv2d(x, w, stride)
    torch.cuda.synchronize()
    want = conv2d_plain(x, w, stride)
    # every output element is summed in a fixed order: run twice, same bits
    require(bool(torch.equal(conv2d(x, w, stride), got)),
            f"{name}: two runs of the conv differ")
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
    max_err, max_err64 = float(err.max()), float(err64.max())
    rel = max_err64 / float(exact.abs().max())
    simt = SIMT_REL_ERR.get(name)
    if simt is not None:
        require(rel <= 2.0 * simt, f"{name}: max |err| / max |f64| = "
                                   f"{rel:.3g}, over twice the SIMT "
                                   f"mainloop's {simt:.3g}")
    del S, exact, err64, err
    item = x.element_size()
    n_bytes = (x.numel() + w.numel() + got.numel()) * item
    dn = str(dtype).replace("torch.", "")
    flops = 2.0 * got.numel() * R
    # the tensor cores' rate as the kernel uses them: three TF32 products a
    # multiply-add for f32, one for bf16 (exact in TF32)
    bound_ms, bound_by = bound(n_bytes, (3.0 if dtype == torch.float32
                                         else 1.0) * flops, "tf32")
    return {"case": name, "kernel": "conv2d", "shape": [list(x.shape),
                                                        list(ws), stride],
            "dtype": dn, "headline": headline,
            "plan": {"tile": list(plan.tile), "splits": plan.cluster,
                     "blocks": plan.blocks},
            "max_abs_err": max_err, "tol_coef": coef, "err_over_tol": ratio,
            "max_abs_err_vs_f64": max_err64,
            "rel_err_f64": rel, "recorded_simt_rel_err_f64": simt,
            "ms": timer.ms(lambda: conv2d(x, w, stride)),
            "plain_ms": timer.ms(lambda: conv2d_plain(x, w, stride)),
            "library_ms": timer.ms(lambda: F.conv2d(x, w, stride=stride)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_tf32_ms": bound(n_bytes, flops, "tf32")[0],
            "bound_3xtf32_ms": bound_3xtf32(n_bytes, flops)}


def check_conv_kept_split(torch, gen) -> dict:
    """The weight's split is made once and kept: a second conv with the
    same weight makes none, and one after an in-place write to the weight
    makes a new one and reads it (doubling the weight doubles the output,
    not a stale copy of it)."""
    from repro_torch.kernels.conv2d import conv2d

    x = _rand(torch, gen, (4, 512, 16, 4), torch.float32, 0.5)
    w = _rand(torch, gen, (512, 512, 3, 3), torch.float32, (512 * 9) ** -0.5)
    s0 = conv2d.weight_splits
    a = conv2d(x, w, 1)
    b = conv2d(x, w, 1)
    made = conv2d.weight_splits - s0
    require(made == 1 and bool(torch.equal(a, b)),
            f"kept split: {made} splits for two convs with one weight")
    w.mul_(2.0)
    c = conv2d(x, w, 1)
    torch.cuda.synchronize()
    made = conv2d.weight_splits - s0
    rel = float((c - 2.0 * a).abs().max() / (2.0 * a).abs().max())
    require(made == 2 and rel <= 1e-6,
            f"kept split after an in-place write: {made} splits, "
            f"|c - 2a| / |2a| = {rel:.3g}")
    return {"case": "conv5_x piece B=4: kept split", "splits_made": made,
            "doubled_rel_err": rel,
            "doubled_bit_equal": bool(torch.equal(c, 2.0 * a))}


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


def ssd_bwd_cases(torch):
    """(name, B, T, H, P, N, chunk, h0, dtype, headline) of the SSD
    backward: the Zamba2-1.2B train shape (the ``train`` phase's), with and
    without h0 (with h0 the final state's gradient is given too), a ragged
    last chunk, Mamba2-2.7B's heads, bf16 x / Bm / Cm, and widths that are
    no multiple of 4."""
    f32, bf16 = torch.float32, torch.bfloat16
    z = (64, 64, 64)
    return [
        ("zamba2 train B=4 T=512", 4, 512, *z, 128, False, f32, True),
        ("zamba2 train B=4 T=512, h0 and dhT", 4, 512, *z, 128, True, f32,
         False),
        ("zamba2 B=2 T=200 (ragged chunk), h0", 2, 200, *z, 128, True, f32,
         False),
        ("mamba2-2.7b heads B=2 T=512", 2, 512, 80, 64, 128, 128, False, f32,
         False),
        ("zamba2 train B=4 T=512 bf16 x", 4, 512, *z, 128, False, bf16,
         False),
        ("odd widths P=18 N=10 L=42, h0", 3, 100, 5, 18, 10, 42, True, f32,
         False),
    ]


# An SSD gradient's tolerance, relative to the largest magnitude of the f64
# gradient it is held against: every gradient is an f32 sum of at most a
# few thousand products (L (P + N) inside a chunk, the heads for dB and dC,
# B T for dA), and such a sum is within ~10^3 2^-24 ~ 6e-5 of its sum of
# magnitudes.
SSD_BWD_TOL = 1e-4


def ssd_saved_plain(torch, x, dt, A, Bm, Cm, h0, chunk):
    """(G, Hin, cum_end) of the forward by the passes' plain versions (f64
    for f64 input)."""
    import repro_torch.kernels.ssd_chunk  # noqa: F401
    K = sys.modules["repro_torch.kernels.ssd_chunk"]

    G = K.ssd_cb_plain(Bm, Cm, chunk)
    S, ce = K.ssd_states_plain(x, dt, A, Bm, chunk)
    Hin, _ = K.ssd_state_pass_plain(S, ce, h0)
    return G, Hin, ce


def ssd_bwd_groups(B, T, H, chunk) -> int:
    """The head groups of the backward's out and states passes: each
    hands on one partial sum of dG, dC or dB per (batch, chunk)."""
    from repro_torch.kernels.ssd_chunk import bwd_heads

    return -(-H // bwd_heads(B, T, H, chunk))


def ssd_bwd_work(B, T, H, P, N, chunk) -> dict:
    """FLOPs of each reversed pass over the rows the sequence has: out_bwd
    the causal dy x^T and M^T dy (L (L + 1) / 2 x P each), the incoming
    state's dC and dHin (L x P x N each) and its row term of d(cum), C . dC
    (L x N); state_pass_bwd two per state
    element and chunk; states_bwd x dS, B dS^T (L x P x N each) and dw;
    cb_bwd the groups' dG, dC and dB added and dG B, dG^T C (causal, x
    N)."""
    c = -(-T // chunk)
    ng = ssd_bwd_groups(B, T, H, chunk)
    w = dict.fromkeys(("out_bwd", "state_pass_bwd", "states_bwd", "cb_bwd"),
                      0)
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        tri = n * (n + 1) // 2
        w["out_bwd"] += H * (2 * tri * P + 2 * n * P * N + n * N)
        w["states_bwd"] += H * (2 * n * P * N + n * N)
        w["cb_bwd"] += ng * (tri / 2 + n * N) + 2 * tri * N
    w["state_pass_bwd"] = c * H * P * N
    return {k: 2.0 * B * v for k, v in w.items()}


def ssd_bwd_bytes(B, T, H, P, N, chunk, item, h0) -> dict:
    """Bytes of each reversed pass and of the whole backward: each input
    read once and each output written once (f32 but x, Bm, Cm, which are
    ``item`` bytes); the passes hand on one partial sum of dG, dC and dB
    per head group."""
    c = -(-T // chunk)
    L = chunk
    ng = ssd_bwd_groups(B, T, H, chunk)
    x, bc = B * T * H * P * item, B * T * N * item
    f = lambda *n: 4 * math.prod(n)
    dy, dt, G = f(B, T, H, P), f(B, T, H), f(B, c, L, L)
    st, row = f(B, c, H, P, N), f(B, c, H, L)
    dGh, dBC = f(B, c, ng, L, L), f(B, c, ng, L, N)
    h = f(B, H, P, N)
    whole = (x + 2 * bc + dt + G + st + f(B, c, H) + dy + (2 * h if h0 else 0)
             + f(B, T, H, P) + dt + f(H) + 2 * f(B, T, N) + (h if h0 else 0))
    return {
        "out_bwd": x + bc + dt + G + st + dy + f(B, T, H, P) + dGh + dBC
        + st + 2 * row,
        "state_pass_bwd": 2 * st + f(B, c, H) + (h if h0 else 0) + st
        + f(B, c, H) + h,
        "states_bwd": x + bc + dt + st + 2 * row + f(B, c, H)
        + 2 * f(B, T, H, P) + dBC + dt + f(B, c, H),
        "cb_bwd": 2 * bc + dGh + 2 * dBC + f(B, c, H) + 2 * f(B, T, N) + f(H),
        "whole": whole}


def ssd_bwd_compare(torch, name, got, refs: dict, names) -> tuple:
    """Each output of ``got`` against each reference's: max |err| within
    SSD_BWD_TOL of the reference's largest magnitude.  Returns (errors,
    err / tol ratios)."""
    errs, ratios = {}, {}
    for ref_name, ref in refs.items():
        for n, a, b in zip(names, got, ref):
            require(tuple(a.shape) == tuple(b.shape)
                    and bool(torch.isfinite(a).all()),
                    f"{name}: {n} shape {tuple(a.shape)} or non-finite")
            e = float((a.double() - b.double()).abs().max())
            scale = float(b.double().abs().max()) + 1e-30
            key = f"{n} vs {ref_name}"
            errs[key] = e
            ratios[key] = e / (SSD_BWD_TOL * scale)
            require(ratios[key] <= 1.0, f"{name}: {key} err {e:.3g} over "
                                        f"{SSD_BWD_TOL} x {scale:.3g}")
    return errs, ratios


def check_ssd_bwd(torch, timer, gen, name, B, T, H, P, N, chunk, h0, dtype,
                  headline) -> dict:
    """The whole backward (``ssd_chunk_scan_bwd``, the four reversed passes
    in one call) against its plain version on the card from the same saved
    forward and against the plain version in f64 from an f64 forward; two
    runs bit for bit."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan_bwd,
                                               ssd_chunk_scan_bwd_plain,
                                               ssd_chunk_scan_train)

    x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, h0, dtype)
    dy = _rand(torch, gen, (B, T, H, P), torch.float32)
    dhT = _rand(torch, gen, (B, H, P, N), torch.float32) if h0 else None
    _, _, saved = ssd_chunk_scan_train(x, dt, A, Bm, Cm, h, chunk)
    run = lambda: ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, saved, dy, dhT, chunk,
                                     want_dh0=h0)
    plain = lambda: ssd_chunk_scan_bwd_plain(x, dt, A, Bm, Cm, saved, dy,
                                             dhT, chunk)
    got = run()
    torch.cuda.synchronize()
    again = run()
    require(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: two runs of the backward differ")
    d64 = [t.double() if t is not None else None
           for t in (x, dt, A, Bm, Cm, h, dy, dhT)]
    s64 = ssd_saved_plain(torch, *d64[:6], chunk)
    f64 = ssd_chunk_scan_bwd_plain(*d64[:5], s64, d64[6], d64[7], chunk)
    # without h0 there is no dh0 to compare
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")[:6 if h0 else 5]
    errs, ratios = ssd_bwd_compare(torch, name, got,
                                   {"plain": plain(), "f64": f64}, names)
    flops = sum(ssd_bwd_work(B, T, H, P, N, chunk).values())
    n_bytes = ssd_bwd_bytes(B, T, H, P, N, chunk, x.element_size(),
                            h0)["whole"]
    bound_ms, bound_by = bound(n_bytes, flops, "float32")
    return {"case": name, "kernel": "ssd_chunk_bwd",
            "bound_3xtf32_ms": bound_3xtf32(n_bytes, flops),
            "shape": {"B": B, "T": T, "H": H, "P": P, "N": N, "chunk": chunk,
                      "h0": h0},
            "dtype": str(dtype).replace("torch.", ""), "headline": headline,
            "max_abs_err": max(v for k, v in errs.items()
                               if k.endswith("vs plain")),
            "errors": errs, "err_over_tol": max(ratios.values()),
            "ratios": ratios, "tol_rel": SSD_BWD_TOL, "bit_identical": True,
            "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
            "ms": timer.ms(run), "plain_ms": timer.ms(plain),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def check_ssd_bwd_passes(torch, timer, gen) -> list[dict]:
    """Each reversed pass alone at the Zamba2 train shape (B=4, T=512, with
    h0 and dhT), the kernel and its plain version given the same inputs
    (the plain chain's outputs of the pass before), held against the plain
    pass and the same pass in f64; two runs bit for bit."""
    import repro_torch.kernels.ssd_chunk  # noqa: F401
    K = sys.modules["repro_torch.kernels.ssd_chunk"]

    B, T, H, P, N, chunk = 4, 512, 64, 64, 64, 128
    x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, True,
                                     torch.float32)
    dy = _rand(torch, gen, (B, T, H, P), torch.float32)
    dhT = _rand(torch, gen, (B, H, P, N), torch.float32)
    G, Hin, ce = ssd_saved_plain(torch, x, dt, A, Bm, Cm, h, chunk)
    # the plain chain, the heads in the kernels' groups
    o = K.ssd_out_bwd_plain(x, dt, A, Cm, G, Hin, dy, chunk)
    dx_o, dG_g, dC_g, dHin, dcum_o, ddt_o = o
    dS, dce, _ = K.ssd_state_pass_bwd_plain(Hin, ce, dHin, dhT)
    _, dB_g, _, dA_part = K.ssd_states_bwd_plain(x, dt, A, Bm, dS, dcum_o,
                                                 ddt_o, dce, dx_o, chunk)
    d = lambda *ts: [t.double() for t in ts]
    passes = {
        "out_bwd": ((x, dt, A, Cm, G, Hin, dy, chunk), K.ssd_out_bwd,
                    K.ssd_out_bwd_plain,
                    ("dx_o", "dG_g", "dC_g", "dHin", "dcum_o", "ddt_o")),
        "state_pass_bwd": ((Hin, ce, dHin, dhT), K.ssd_state_pass_bwd,
                           K.ssd_state_pass_bwd_plain,
                           ("dS", "dce", "dh0")),
        "states_bwd": ((x, dt, A, Bm, dS, dcum_o, ddt_o, dce, dx_o, chunk),
                       K.ssd_states_bwd, K.ssd_states_bwd_plain,
                       ("dx", "dB_g", "ddt", "dA_part")),
        "cb_bwd": ((Bm, Cm, dG_g, dB_g, dC_g, dA_part, chunk), K.ssd_cb_bwd,
                   K.ssd_cb_bwd_plain, ("dB", "dC", "dA")),
    }
    work = ssd_bwd_work(B, T, H, P, N, chunk)
    nbytes = ssd_bwd_bytes(B, T, H, P, N, chunk, 4, True)
    plan = K.ssd_bwd_plan(B, T, H, P, N, chunk)
    out = []
    for name, (args, kern, plain, names) in passes.items():
        run = lambda: kern(*args)
        got = run()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, run())),
                f"SSD backward pass {name}: two runs differ")
        a64 = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
        refs = {"plain": plain(*args), "f64": plain(*a64)}
        errs, ratios = ssd_bwd_compare(torch, f"SSD backward pass {name}",
                                       got, refs, names)
        bound_ms, bound_by = bound(nbytes[name], work[name], "float32")
        p = plan[name]
        out.append({
            "case": f"zamba2 train B=4 T=512, h0: pass {name}",
            "kernel": f"ssd_chunk.{name}", "dtype": "float32",
            "headline": True,
            "bound_3xtf32_ms": bound_3xtf32(nbytes[name], work[name]),
            "plan": {"grid": list(p.grid), "threads": p.threads,
                     "smem": p.smem, "blocks_per_sm": p.blocks_per_sm},
            "max_abs_err": max(v for k, v in errs.items()
                               if k.endswith("vs plain")),
            "errors": errs, "err_over_tol": max(ratios.values()),
            "ratios": ratios, "tol_rel": SSD_BWD_TOL,
            "gflop": work[name] / 1e9, "mbytes": nbytes[name] / 1e6,
            "ms": timer.ms(run), "plain_ms": timer.ms(lambda: plain(*args)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def check_grouped_gemm(torch, timer, gen, name, tokens, held) -> list[dict]:
    """The experts' grouped GEMM (``kernels/grouped_gemm.py``) at
    granite-4.0-h-small's widths, on a real routing of ``tokens`` random
    tokens (top-10 of 72, ``held`` experts held): gate/up (rows gathered,
    K 4096, N 768) and down (gated, scattered to slot order, K 768, N
    4096), each against its plain version (f32 products, one rounding to
    bf16: within 2^-7 of the largest output, the two sums' orders apart)
    and bit for bit itself on a second run."""
    from repro_torch.kernels.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_plain)
    from repro_torch.models.moe import route

    D, F, E, K = 4096, 768, 72, 10
    bf = torch.bfloat16
    x = torch.randn(tokens, D, generator=gen, device="cuda").to(bf)
    router = torch.randn(D, E, generator=gen, device="cuda") / 64
    w1 = (torch.randn(held, D, F, generator=gen, device="cuda") / 64).to(bf)
    w2 = (torch.randn(held, F, D, generator=gen, device="cuda")
          / F ** 0.5).to(bf)
    gates, is_held, order, offsets, counts = route(router, x, K, 0, held)
    token = torch.div(order, K, rounding_mode="floor")
    scale = torch.where(is_held, gates, torch.zeros_like(gates))[order]
    a = torch.randn(tokens * K, F, generator=gen, device="cuda").to(bf)
    sizes = counts[:held].tolist()
    rows = sum(sizes)
    out = []
    for proj, k_, n_, run, plain in (
            ("gate/up", D, F,
             lambda: grouped_gemm(x, w1, offsets, rows=token),
             lambda: grouped_gemm_plain(x, w1, offsets, rows=token)),
            ("down", F, D,
             lambda: grouped_gemm(a, w2, offsets, scale=scale, dst=order,
                                  out=torch.zeros(tokens * K, D, dtype=bf,
                                                  device="cuda")),
             lambda: grouped_gemm_plain(a, w2, offsets, scale=scale,
                                        dst=order, out=torch.zeros(
                                            tokens * K, D, dtype=bf,
                                            device="cuda")))):
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        live = slice(0, rows) if proj == "gate/up" else slice(None)
        err = float((got[live].float() - want[live].float()).abs().max()
                    / want[live].float().abs().max())
        require(err <= 2.0 ** -7, f"{name} {proj}: {err:.3e} from plain")
        require(bool(torch.equal(got[live], again[live])),
                f"{name} {proj}: two runs differ")
        flops = 2.0 * rows * k_ * n_
        n_bytes = 2 * (rows * (k_ + n_)
                       + sum(c > 0 for c in sizes) * k_ * n_)
        bound_ms, bound_by = bound(n_bytes, flops, "bfloat16")
        out.append({"case": f"{name} {proj}", "kernel": "grouped_gemm",
                    "shape": {"tokens": tokens, "held": held, "rows": rows,
                              "K": k_, "N": n_,
                              "empty": sum(c == 0 for c in sizes)},
                    "dtype": "bfloat16", "rel_err": err,
                    "ms": timer.ms(run), "plain_ms": timer.ms(plain),
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def phase_kernels(torch) -> list[dict]:
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [check_gemm(torch, timer, gen, *c) for c in gemm_cases(torch)]
    # the experts' grouped GEMM: a decode step's 8 tokens, a prefill's 4096
    for tokens in (8, 4096):
        cases += check_grouped_gemm(torch, timer, gen,
                                    f"experts of {tokens} tokens", tokens, 18)
    cases += [check_stacked(torch, timer, gen, t_p, b, F)
              for b, F in STACKED_W for t_p in STACKED_T_P]
    # the mesh's stacked launch at gemma-2b's shapes (phase serving (c))
    cases += [check_stacked(torch, timer, gen, t_p, b, F)
              for b, F in GEMMA_FFN for t_p in (1, 42, 682)]
    # and at the frontend models' (phase families (a), (b))
    cases += [check_stacked(torch, timer, gen, t_p, b, F)
              for _, arch, *_ in FRONTEND_PARTS
              for t_p in family_t_ps(arch) for b, F in family_ffn(arch)]
    cases += [check_conv(torch, timer, *c) for c in conv_cases(torch)]
    cases += [check_ssd(torch, timer, gen, *c) for c in ssd_cases(torch)]
    cases += check_ssd_passes(torch, timer, gen)
    cases += [check_ssd_bwd(torch, timer, gen, *c)
              for c in ssd_bwd_cases(torch)]
    cases += check_ssd_bwd_passes(torch, timer, gen)
    folds = [check_conv_fold(torch, gen, f"{n}: 10 pieces folded vs one by "
                             "one", (10,) + xs, ws)
             for n, xs, ws in (("conv4_2", (512, 30, 6), (512, 512, 3, 3)),
                               ("conv5_x", (512, 16, 4), (512, 512, 3, 3)))]
    emit({"phase": "kernels", "timing": "median of 15 calls, CUDA events, "
          "L2 overwritten before each call, TF32 off", "cases": cases,
          "folded_vs_pieces": folds,
          "conv_kept_split": check_conv_kept_split(torch, gen)})
    return cases


def kernel_ms(torch, timer, fn, calls: int = 7) -> dict:
    """The median device ms of each SSD kernel that ``fn`` launches, from
    a profile of ``calls`` calls, the L2 overwritten before each (as
    ``Timer`` times them)."""
    import collections
    import re
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    fn()
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    ns = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        m = re.search(r"(ssd_\w+_kernel)", ev.name())
        if m and ev.device_type() == DeviceType.CUDA \
                and not ev.is_hidden_event():
            ns[m.group(1)].append(ev.duration_ns())
    require(bool(ns), "no SSD kernel rows in the profile")
    return {k: statistics.median(v) / 1e6 for k, v in ns.items()}


def time_kernels(torch, checkout: str) -> None:
    """Only time ``skinny_gemm``, ``conv2d``, ``ssd_chunk_scan`` and
    ``ssd_chunk_scan_bwd`` of the ``repro_torch`` under ``checkout/src`` at
    this script's f32 cases (the SSD's whole-sequence ones), as the
    ``kernels`` phase times them (the backward also kernel by kernel, from
    a profile), and print one JSON line: run it on two checkouts in one
    call (parent, change, change, parent) to hold two versions of the
    kernels against each other on one card.  The wrappers' signatures are
    the same in every version of the port."""
    import repro_torch
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.skinny_gemm import skinny_gemm
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                               ssd_chunk_scan_bwd,
                                               ssd_chunk_scan_train)

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
        x, w = conv_inputs(torch, name, xs, sl, ws, dtype)
        rows.append({"case": name, "kernel": "conv2d",
                     "ms": timer.ms(lambda: conv2d(x, w, stride)),
                     "rel_err_f64": rel_err_f64(torch, conv2d(x, w, stride),
                                                x, w, stride)})
        del x, w
    for name, B, T, H, P, N, chunk, h0, dtype, entry, _ in ssd_cases(torch):
        if dtype != torch.float32 or entry != "scan":
            continue
        x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, h0,
                                         dtype)
        rows.append({"case": name, "kernel": "ssd_chunk", "ms": timer.ms(
            lambda: ssd_chunk_scan(x, dt, A, Bm, Cm, h, chunk))})
    for name, B, T, H, P, N, chunk, h0, dtype, _ in ssd_bwd_cases(torch):
        if dtype != torch.float32:
            continue
        x, dt, A, Bm, Cm, h = ssd_inputs(torch, gen, B, T, H, P, N, h0,
                                         dtype)
        dy = _rand(torch, gen, (B, T, H, P), torch.float32)
        dhT = _rand(torch, gen, (B, H, P, N), torch.float32) if h0 else None
        _, _, saved = ssd_chunk_scan_train(x, dt, A, Bm, Cm, h, chunk)

        def run():
            return ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, saved, dy, dhT,
                                      chunk, want_dh0=h0)
        rows.append({"case": name, "kernel": "ssd_chunk_bwd",
                     "ms": timer.ms(run),
                     "kernels_ms": kernel_ms(torch, timer, run)})
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


def phase_mesh_async(torch) -> None:
    """The one-program backend issues a run and returns without waiting for
    it, at the size of a served prefill's coded FFN: 1,797 tokens (the
    benchmark's tokens a prefill call) through Zamba2-1.2B's FFN widths,
    d 2048, F 8192, f32, MDS (10, 6), worker 1 dead, worker 2 straggling."""
    import torch.nn.functional as Fn

    from repro_torch.core import MDSScheme, coded_matmul
    from repro_torch.dist import MeshExecutor

    T, D, F = 1797, 2048, 8192
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = _rand(torch, gen, (T, D), torch.float32)
    w_in = _rand(torch, gen, (D, F), torch.float32, D ** -0.5)
    w_gate = _rand(torch, gen, (D, F), torch.float32, D ** -0.5)
    w_out = _rand(torch, gen, (F, D), torch.float32, F ** -0.5)
    code = MDSScheme.make(N_WORKERS, 6)
    mx = MeshExecutor(dead=(1,), stragglers=(2,))
    run_op, busy = mx.run_op, []

    def probed(op):  # is the card still working when run_op returns?
        out = run_op(op)
        busy.append(not torch.cuda.current_stream().query())
        return out

    def waited(op):  # the run as run_op made it before: then a synchronise
        out = run_op(op)
        torch.cuda.synchronize()
        return out

    # ~50 ms of device work queued ahead: the card is behind the host, as
    # in a served prefill, however slow this machine's host is
    pad = _rand(torch, gen, (4096, 4096), torch.float32)

    def behind():
        for _ in range(20):
            pad @ pad

    def ffn(h):
        a = coded_matmul(h, w_in, code, executor=mx)
        g = coded_matmul(h, w_gate, code, executor=mx)
        return coded_matmul(Fn.gelu(g) * a, w_out, code, executor=mx)

    reports = []
    try:
        ffn(x)  # every graph captured, every kernel built
        mx.settle()
        torch.cuda.synchronize()
        mx.run_op = probed
        mx.on_report = reports.append
        # (a) the run returns with the card still busy; its result read in
        # stream order is the result of the same run waited for
        behind()
        y = coded_matmul(x, w_in, code, executor=mx)
        require(busy == [True], "the stream was idle when run_op returned")
        mx.run_op = waited
        y_sync = coded_matmul(x, w_in, code, executor=mx)
        mx.run_op = probed
        require(bool(torch.equal(y, y_sync)),
                "a run not waited for differs from the same run waited for")
        want = x @ w_in
        amp = decode_amplification(code, mx.last_report.subset)
        tol = amp * D ** 0.5 * 2.0 ** -24 * float(want.abs().max())
        err = float((y - want).abs().max())
        require(err <= tol, f"coded matmul err {err} > {tol}")
        # (b) the FFN's three runs back to back, the host ahead of the card
        torch.cuda.synchronize()
        mx.settle()
        q0, n0 = mx.queued_runs, len(reports)
        behind()
        t0 = time.perf_counter()
        ffn(x)
        host_ms = (time.perf_counter() - t0) * 1e3
        queued = mx.queued_runs - q0
        require(len(reports) == n0, "a report delivered before a settle")
        torch.cuda.synchronize()
        mx.settle()
        # every run since the warm-up's three: y, y_sync and the FFN's
        require(len(reports) == n0 + 3 == mx.run_count - 3,
                f"{len(reports)} reports for {mx.run_count - 3} runs")
        require(all(r.wall_s > 0.0 and r.t_complete == r.wall_s
                    for r in reports), "a report with no time on the card")
        require(queued == 2, f"{queued} of the FFN's 3 runs queued behind "
                             "the one before (the first has none pending)")
        # (c) runs never overlap by stream order alone: another stream is
        # refused
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                coded_matmul(x, w_in, code, executor=mx)
        except RuntimeError as e:
            refused = "stream" in str(e)
        else:
            refused = False
        require(refused, "a run on another stream was not refused")
    finally:
        mx.close()
    ffn_ms = [r.wall_s * 1e3 for r in reports[-3:]]
    emit({"phase": "mesh_async",
          "setup": "MeshExecutor(dead=(1,), stragglers=(2,)), MDS (10, 6), "
                   f"x ({T}, {D}) f32, FFN {D} -> {F} -> {D}",
          "busy_when_run_op_returned": busy[0], "bit_identical": True,
          "max_abs_err": err, "tol": tol,
          "ffn_queued_runs": queued, "ffn_host_issue_ms": host_ms,
          "ffn_run_ms_on_card": ffn_ms,
          "ffn_card_ms": sum(ffn_ms), "refused_other_stream": True})


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


def averages(prof):
    """``prof.key_averages()``, grouped once per profile: the grouping
    walks every event in Python, and each profile is read several
    times."""
    rows = getattr(prof, "_chip_smoke_rows", None)
    if rows is None:
        rows = prof._chip_smoke_rows = prof.key_averages()
    return rows


def device_time_of(prof) -> dict:
    """Sum of device time and the top kernels from a torch.profiler run.
    Only rows that are device kernels count: an operator row repeats the
    time of the kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for ev in averages(prof):
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
                   for ev in averages(prof)
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
    for ev in averages(prof):
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
            for ev in averages(prof)
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
        s0 = conv_kernel.weight_splits
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
            "conv2d_weight_splits": conv_kernel.weight_splits - s0,
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
        # every weight's split was made by the first requests and is kept
        require(requests[-1]["conv2d_weight_splits"] == 0,
                f"a repeated request split "
                f"{requests[-1]['conv2d_weight_splits']} weights again")
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
# phase 8: serving under load through the continuous-batching scheduler
# ---------------------------------------------------------------------------

GEMMA_K = 6
SERVE_REQUESTS = 32
SERVE_RATE = 0.02       # arrivals per virtual second (a coded run costs 1 s)
SERVE_MASTER_S = 1e-3   # virtual cost of a model call's master-side work
SERVE_BATCH = 8
SERVE_CHUNK = 256
SERVE_BLOCK = 16
SERVE_ARMS = (("grouped", dict(packed=False), False),
              ("packed", dict(packed=True), False),
              ("chunked", dict(packed=True, chunk_tokens=SERVE_CHUNK), False),
              ("cached", dict(packed=True, chunk_tokens=SERVE_CHUNK), True))
SERVE_SAMPLE = tuple(range(0, SERVE_REQUESTS, SERVE_REQUESTS // 8))
ZAMBA2_SERVE_REQUESTS = 8


def gemma_workload(vocab: int):
    """32 Poisson arrivals in virtual time; prompts of 4 shared 256-token
    prefix families (Zipf a = 1.2) and a fresh 16-256-token suffix; 8-16
    new tokens each."""
    from repro_torch.serving import (LengthDist, PoissonArrivals,
                                     SharedPrefixDist, Workload)

    return Workload(
        PoissonArrivals(SERVE_RATE), LengthDist.fixed(1),
        LengthDist(tuple(range(8, 17))), vocab=vocab, seed=SEED + 31,
        shared_prefix=SharedPrefixDist(
            4, 256, LengthDist(tuple(range(16, 257))), zipf_a=1.2,
            vocab=vocab, seed=SEED + 32))


def wall_scheduler():
    """``ServingScheduler`` that also reads the wall clock at each step's
    start and at each model call's end, keyed by the virtual instant (each
    call advances it by at least ``master_call_s``, so the keys differ):
    a request's wall TTFT and e2e run from its admission step's start."""
    from repro_torch.serving import ServingScheduler

    class WallTimed(ServingScheduler):
        def serve(self, requests):
            self.step_wall, self.call_wall = {}, {}
            self.w0 = time.perf_counter()
            return super().serve(requests)

        def _apply_membership(self, idx, t, qdepth, membership):
            self.step_wall[t] = time.perf_counter() - self.w0
            return super()._apply_membership(idx, t, qdepth, membership)

        def _timed_call(self, fn, *args, at=None):
            out, dt = super()._timed_call(fn, *args, at=at)
            self.call_wall[at + dt] = time.perf_counter() - self.w0
            return out, dt

        def wall_metrics(self, res) -> dict:
            from repro_torch.serving import percentiles

            ttft, e2e, tpot = [], [], []
            for r in res.records:
                a = self.step_wall[r.admit_s]
                f, d = self.call_wall[r.first_token_s], self.call_wall[r.done_s]
                ttft.append(f - a)
                e2e.append(d - a)
                if r.n_tokens > 1:
                    tpot.append((d - f) / (r.n_tokens - 1))
            return {"ttft_s": percentiles(ttft), "tpot_s": percentiles(tpot),
                    "e2e_s": percentiles(e2e)}

    return WallTimed


def record_coded_ops(ex) -> list:
    """(t_p, d_in, d_out) of every coded op ``ex`` runs, until
    ``del ex.run_op``."""
    ops, run_op = [], ex.run_op

    def recording(op):
        ops.append((op.x.shape[1], op.w.shape[0], op.w.shape[1]))
        return run_op(op)

    ex.run_op = recording
    return ops


def coded_op_design(torch, ops, live: int):
    """The skinny-GEMM launches the design implies for ``ops`` on the
    pool: per op one encode (10, 6) @ (6, t_p d_in), one piece GEMM per
    live worker (every live worker computes its piece on the virtual
    clock, the straggler too) and one decode (6, 6) @ (6, t_p d_out),
    each at the plan ``piece_plan`` gives its shape."""
    import collections

    want = collections.Counter()
    for t_p, d_in, d_out in ops:
        want[gemm_key(torch, N_WORKERS, GEMMA_K, t_p * d_in)] += 1
        want[gemm_key(torch, t_p, d_in, d_out)] += live
        want[gemm_key(torch, GEMMA_K, GEMMA_K, t_p * d_out)] += 1
    return want


def tally_held(torch, tally) -> dict:
    """Launches of the shapes the ``kernels`` phase holds as cases."""
    held = set()
    for _, A_src, F, *_ in gemm_cases(torch):
        m, b = A_src if isinstance(A_src, tuple) else A_src.shape
        held.add((m, b, F))
    return {f"{m}x{b}x{F}": n for (_, _, m, b, F), n
            in sorted(tally.counts.items()) if (m, b, F) in held}


def tally_summary(tally) -> list:
    """Launches by (regime, variant), with the shapes' range."""
    import collections

    by = collections.defaultdict(lambda: [0, set()])
    for (r, v, m, b, F), n in tally.counts.items():
        by[(r, v)][0] += n
        by[(r, v)][1].add((m, b, F))
    return [{"regime": r, "variant": v, "launches": n,
             "shapes": len(shapes), "m": [min(s[0] for s in shapes),
                                          max(s[0] for s in shapes)]}
            for (r, v), (n, shapes) in sorted(by.items())]


def uncoded_logits(torch, cfg, params, prompt, generated) -> "torch.Tensor":
    """The uncoded model's next-token logits after ``prompt`` and
    ``generated``."""
    import numpy as np
    from repro_torch.models import model as M

    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(generated, np.int64)])
    toks = torch.as_tensor(seq[None], device="cuda")
    logits, _ = M.prefill(cfg, params, toks, max_seq=len(seq))
    return logits[0, 0, : cfg.vocab]


def hold_tokens(torch, cfg, params, reqs, got: dict, want: dict,
                label: str) -> dict:
    """Each request's tokens equal, outside near-ties: where two token
    lists first differ, both tokens must be within 1e-3 max|logit| of the
    top of the uncoded model's logits there (two coded runs of other
    batch shapes round differently; such a tie may go either way, and the
    request then continues on its own)."""
    by_rid = {r.rid: r for r in reqs}
    equal, ties = 0, []
    for rid, a in want.items():
        b = got[rid]
        if a == b:
            equal += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y) \
            if len(a) == len(b) else None
        require(j is not None, f"{label}: request {rid} has {len(b)} "
                               f"tokens, {len(a)} expected")
        ref = uncoded_logits(torch, cfg, params, by_rid[rid].prompt, a[:j])
        tol = 1e-3 * float(ref.abs().max())
        top = float(ref.max())
        gap = max(top - float(ref[a[j]]), top - float(ref[b[j]]))
        require(gap <= tol, f"{label}: request {rid} differs at token {j} "
                            f"({a[j]} vs {b[j]}) outside a near-tie: gap "
                            f"{gap} > {tol}")
        ties.append({"rid": rid, "at": j, "gap": gap, "tol": tol})
    return {"requests": len(want), "equal": equal, "near_ties": ties}


def serve_once(torch, sched, reqs, *, profile=False):
    """One serve of copies of ``reqs``: (result, wall s, profile or
    None)."""
    import dataclasses

    copies = [dataclasses.replace(r) for r in reqs]
    torch.cuda.synchronize()
    if not profile:
        t0 = time.perf_counter()
        res = sched.serve(copies)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, None
    res, wall, prof, _ = device_profile(torch, lambda: sched.serve(copies))
    return res, wall, prof


def tokens_of(res) -> dict:
    return {c.rid: c.tokens.tolist() for c in res.completions}


def step_rows(res) -> dict:
    s = res.steps
    return {"steps": len(s), "runs": sum(x.runs for x in s),
            "dispatches": sum(x.dispatches for x in s),
            "prefill_runs": sum(x.prefill_runs for x in s),
            "prefill_dispatches": sum(x.prefill_dispatches for x in s),
            "max_prefill_runs_in_a_step": max(x.prefill_runs for x in s),
            "max_chunks_in_a_step": max(x.prefill_chunks for x in s),
            "packed_tokens": sum(x.packed_tokens for x in s),
            "packed_pad_tokens": sum(x.packed_pad_tokens for x in s),
            "prefix_hit_tokens": sum(x.prefix_hit_tokens for x in s),
            "batch_mean": sum(x.batch for x in s) / len(s),
            "t_end_virtual_s": res.t_end}


def serving_gemma(torch) -> tuple:
    """(a) gemma-2b at full width, f32, MDS (10, 6) on the zamba2 phase's
    pool (FakeClock, dead worker 1, 50x straggler 2), four arms."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import FakeClock
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, PrefixCache, summarize

    cfg = dataclasses.replace(get_config("gemma-2b"), dtype=torch.float32)
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.hd, cfg.d_ff, cfg.vocab)
            == (18, 2048, 8, 1, 256, 16384, 256000),
            "gemma-2b at full width")
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 30),
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wl = gemma_workload(cfg.vocab)
    reqs = wl.generate(SERVE_REQUESTS)
    gemms = 3 * cfg.n_layers
    WallTimed = wall_scheduler()
    ex = make_executor(FakeClock())
    live = N_WORKERS - len(ex.pool.fault_plan.dead)
    arms, counts_all = {}, {}
    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, GEMMA_K), executor=ex)
        for name, kw, cached in SERVE_ARMS:
            cache = PrefixCache(block=SERVE_BLOCK) if cached else None
            sched = WallTimed(eng, max_seq=wl.max_seq, max_batch=SERVE_BATCH,
                              master_call_s=SERVE_MASTER_S,
                              prefix_cache=cache, **kw)
            ops = record_coded_ops(ex)
            # one serve of each arm, profiled: its device ms and idle
            # share come from the same run as its counts and walls
            with LaunchTally() as tally:
                zero_launch_counters()
                res, wall, prof = serve_once(torch, sched, reqs,
                                             profile=True)
                counts = read_launch_counters()
            del ex.run_op
            want = coded_op_design(torch, ops, live)
            require(dict(tally.counts) == dict(want),
                    f"serving {name}: skinny-GEMM launches by (regime, "
                    f"variant, shape) differ from the design of its "
                    f"{len(ops)} coded ops")
            require(counts["skinny_gemm"] == sum(want.values()) > 0,
                    f"serving {name}: {counts['skinny_gemm']} skinny-GEMM "
                    f"launches, the design implies {sum(want.values())}")
            require(all(k[1] == "narrow" for k in tally.counts
                        if k[0] == "coding"),
                    f"serving {name}: a coding launch was not `narrow`")
            require(len(ops) == sum(s.runs for s in res.steps),
                    f"serving {name}: {len(ops)} coded ops, "
                    f"{sum(s.runs for s in res.steps)} runs booked")
            for k, v in counts.items():
                counts_all[k] = counts_all.get(k, 0) + v
            arms[name] = {"res": res, "wall": wall, "sched": sched,
                          "cache": cache, "tally": tally, "counts": counts,
                          "profile": prof}
    finally:
        ex.close()

    # ---- checks --------------------------------------------------------
    toks = {name: tokens_of(a["res"]) for name, a in arms.items()}
    require(all(len(t) == SERVE_REQUESTS for t in toks.values()),
            "serving: an arm lost requests")
    across = {name: hold_tokens(torch, cfg, params, reqs, toks[name],
                                toks["grouped"], f"serving {name}")
              for name in toks if name != "grouped"}
    sample = [r for r in reqs if r.rid in SERVE_SAMPLE]
    plain = Engine(dataclasses.replace(cfg, coded_n=0, coded_k=0), params)
    uncoded = {c.rid: c.tokens.tolist() for c in plain.generate(
        [dataclasses.replace(r) for r in sample])}
    vs_uncoded = {name: hold_tokens(
        torch, cfg, params, reqs, {rid: toks[name][rid] for rid in uncoded},
        uncoded, f"serving {name} vs uncoded") for name in toks}
    # one coded run per GEMM for a whole packed admission, however many
    # lengths it holds; the grouped arm pays one per distinct length
    lens = {r.rid: len(r.prompt) for r in reqs}
    mixed = 0
    for name in ("grouped", "packed"):
        res = arms[name]["res"]
        for st in res.steps:
            cold = [r for r in res.records
                    if r.admit_s == st.t_start and st.admitted]
            if not st.admitted:
                continue
            distinct = len({lens[r.rid] for r in cold})
            want = gemms * (1 if name == "packed" else distinct)
            require(st.prefill_runs == want
                    and st.prefill_dispatches == want * N_WORKERS,
                    f"serving {name} step {st.step}: {st.prefill_runs} "
                    f"prefill runs, {st.prefill_dispatches} dispatches for "
                    f"{len(cold)} prompts of {distinct} lengths (design "
                    f"{want}, {want * N_WORKERS})")
            if name == "packed" and distinct > 1:
                mixed += 1
    require(mixed > 0, "serving packed: no admission mixed lengths")
    # chunked prefill: every prompt (> 256 tokens) streams; each chunk of
    # <= 256 tokens is one call of 54 coded runs
    for name in ("chunked", "cached"):
        for st in arms[name]["res"].steps:
            require(st.packed_tokens == 0
                    and st.prefill_runs == gemms * st.prefill_chunks,
                    f"serving {name} step {st.step}: {st.prefill_runs} "
                    f"prefill runs for {st.prefill_chunks} chunks")
    pc = arms["cached"]["cache"]
    r3, r4 = step_rows(arms["chunked"]["res"]), step_rows(arms["cached"]["res"])
    require(pc.stats.hits > 0 and r4["prefix_hit_tokens"] > 0,
            "serving cached: no prefix hit")
    require(r4["runs"] < r3["runs"] and r4["dispatches"] < r3["dispatches"],
            f"serving cached: {r4['runs']} runs / {r4['dispatches']} "
            f"dispatches, not below chunked's {r3['runs']} / "
            f"{r3['dispatches']}")

    out = {}
    for name, a in arms.items():
        res = a["res"]
        summ = summarize(res)
        out[name] = {
            **step_rows(res), "wall_s": a["wall"],
            "virtual": {k: summ[k] for k in ("ttft_s", "tpot_s", "e2e_s")},
            "wall_from_admission": a["sched"].wall_metrics(res),
            "prefix_cache": (dataclasses.asdict(a["cache"].stats)
                             | {"bytes": a["cache"].bytes,
                                "blocks": a["cache"].n_blocks}
                             if a["cache"] is not None else None),
            "profile": a["profile"], "launches": a["counts"],
            "skinny_gemm_by_regime": tally_summary(a["tally"]),
            "launches_of_kernels_cases": tally_held(torch, a["tally"]),
            "tokens_vs_grouped": across.get(name),
            "sample_vs_uncoded": vs_uncoded[name]}
    emit({"phase": "serving", "part": "a: gemma-2b",
          "model": "gemma-2b, 18 layers, d_model 2048, 8 heads, MQA, "
                   "head_dim 256, geglu d_ff 16384, vocab 256000, f32, "
                   "seeded random weights",
          "params": M.param_count(params), "init_s": init_s,
          "coded": {"scheme": "mds", "n": N_WORKERS, "k": GEMMA_K,
                    "faults": "dead={1}, straggler={2: 50x}",
                    "clock": "FakeClock + DeterministicDelay(1.0)",
                    "master_call_s": SERVE_MASTER_S},
          "traffic": {"requests": SERVE_REQUESTS, "poisson_rate": SERVE_RATE,
                      "families": 4, "prefix": 256, "suffix": [16, 256],
                      "zipf_a": 1.2, "max_new": [8, 16],
                      "max_batch": SERVE_BATCH, "max_seq": wl.max_seq,
                      "prompt_tokens": sum(lens.values())},
          "nvidia_smi": nvidia_smi_line(), "arms": out})
    gemma = {"cfg": cfg, "params": params, "reqs": reqs,
             "max_seq": wl.max_seq, "packed": toks["packed"],
             "packed_wall_s": arms["packed"]["wall"]}
    return counts_all, gemma


def serving_zamba2(torch, z) -> dict:
    """(b) Zamba2-1.2B through the scheduler: the zamba2 phase's weights
    and pool configuration, 8 requests of 64-512 tokens.  ``packed=None``
    picks the grouped path (an SSM's state integrates padding)."""
    import dataclasses

    from repro_torch.dist import FakeClock
    from repro_torch.serving import (Engine, LengthDist, PoissonArrivals,
                                     Workload, summarize)

    cfg, params = z["cfg"], z["params"]
    wl = Workload(PoissonArrivals(SERVE_RATE),
                  LengthDist(tuple(range(64, 513, 64))),
                  LengthDist(tuple(range(8, 17))), vocab=cfg.vocab,
                  seed=SEED + 40)
    reqs = wl.generate(ZAMBA2_SERVE_REQUESTS)
    ex = make_executor(FakeClock())
    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, ZAMBA2_K), executor=ex)
        sched = wall_scheduler()(eng, max_seq=wl.max_seq,
                                 max_batch=SERVE_BATCH,
                                 master_call_s=SERVE_MASTER_S)
        require(not sched.packed, "zamba2: packed=None chose packing")
        groups, prefill_batch = [], eng.prefill_batch
        eng.prefill_batch = lambda p, ms: (groups.append(p.shape),
                                           prefill_batch(p, ms))[1]
        zero_launch_counters()
        res, wall, _ = serve_once(torch, sched, reqs)
        counts = read_launch_counters()
        del eng.prefill_batch
        served = tokens_of(res)
        t0 = time.perf_counter()
        gen = {c.rid: c.tokens.tolist() for c in eng.generate(
            [dataclasses.replace(r) for r in reqs])}
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
    finally:
        ex.close()
    require(counts["ssd_chunk"] == cfg.n_layers * len(groups) > 0,
            f"zamba2 serve: {counts['ssd_chunk']} SSD launches for "
            f"{len(groups)} prefill groups (design {cfg.n_layers} each)")
    for p in ("cb", "states", "state_pass", "out"):
        require(counts[f"ssd_chunk.{p}"] == counts["ssd_chunk"],
                f"zamba2 serve: SSD pass {p} launched "
                f"{counts[f'ssd_chunk.{p}']} times")
    require(counts["skinny_gemm"] > 0, "zamba2 serve: no coded GEMM ran")
    held = hold_tokens(torch, cfg, params, reqs, served, gen,
                       "zamba2 serve vs generate")
    summ = summarize(res)
    out = {"phase": "serving", "part": "b: zamba2-1.2b",
           "requests": len(reqs), "prompts": [len(r.prompt) for r in reqs],
           "packed": sched.packed, "prefill_groups": [list(g) for g in groups],
           **step_rows(res), "wall_s": wall, "generate_wall_s": gen_wall,
           "virtual": {k: summ[k] for k in ("ttft_s", "tpot_s", "e2e_s")},
           "wall_from_admission": sched.wall_metrics(res),
           "launches": counts, "tokens_vs_generate": held}
    emit(out)
    return counts


def modeled_mesh():
    """``MeshExecutor`` whose runs are booked at the pool's modeled time:
    every coded run of the FakeClock pool (DeterministicDelay(1.0), k of
    the healthy workers first) completes at 1.0 s, so the scheduler lays
    out the same steps, groups and shapes on the mesh as on the pool, and
    a second serve replays every graph of the first."""
    from repro_torch.dist import FakeClock, MeshExecutor

    class ModeledMesh(MeshExecutor):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.pool.clock = FakeClock()

        def _book(self, scheme, subset, wall, t_submit=None):
            self.walls.append(wall)
            super()._book(scheme, subset, 1.0, t_submit)

    mx = ModeledMesh(dead=(1,), stragglers=(2,))
    mx.walls = []
    return mx


def mesh_serves(torch, cfg, params, reqs, max_seq, want_tokens,
                label) -> dict:
    """Serve the packed arm twice on a modeled mesh: tokens equal to
    ``want_tokens``; one graph per (program, weight); the second serve
    captures nothing and calls no kernel wrapper."""
    from repro_torch.serving import Engine, ServingScheduler

    mx = modeled_mesh()
    gkeys, pkeys, run_op = set(), set(), mx.run_op

    def keyed(op):
        key = mx._key(op, mx._subset(op.scheme))
        pkeys.add(key)
        gkeys.add(key + (op.w.data_ptr(),))
        return run_op(op)

    mx.run_op = keyed
    rows = []
    try:
        eng = Engine(cfg, params, coded=(N_WORKERS, GEMMA_K), executor=mx)
        for serve in ("first (captures)", "replayed"):
            sched = ServingScheduler(eng, max_seq=max_seq,
                                     max_batch=SERVE_BATCH,
                                     master_call_s=SERVE_MASTER_S,
                                     packed=True)
            g0, r0, w0 = mx.graph_count, mx.replay_count, len(mx.walls)
            zero_launch_counters()
            res, wall, _ = serve_once(torch, sched, reqs)
            counts = read_launch_counters()
            require(tokens_of(res) == want_tokens,
                    f"{label} {serve}: the mesh served other tokens than "
                    "the pool")
            require(mx.graph_count == len(gkeys)
                    and mx.compile_count == len(pkeys),
                    f"{label}: {mx.graph_count} graphs / "
                    f"{mx.compile_count} programs for {len(gkeys)} "
                    f"(program, weight) pairs / {len(pkeys)} programs")
            runs = sum(s.runs for s in res.steps)
            if serve == "replayed":
                require(mx.graph_count == g0, f"{label}: the second serve "
                                              "captured new graphs")
                require(counts["skinny_gemm"] == 0
                        and counts["piece_gemm_stacked"] == 0,
                        f"{label}: a wrapper was called in a replayed "
                        f"serve: {counts}")
            require(mx.replay_count - r0 == runs, f"{label} {serve}: "
                    f"{mx.replay_count - r0} replays for {runs} runs")
            walls = mx.walls[w0:]
            rows.append({"serve": serve, "wall_s": wall, "runs": runs,
                         "graphs_captured": mx.graph_count - g0,
                         "run_wall_ms": t_compute_stats(walls),
                         "launches": counts})
    finally:
        mx.close()
    return {"programs": len(pkeys), "graphs": len(gkeys), "serves": rows,
            "first_launches": rows[0]["launches"]}


def serving_mesh(torch, gemma) -> dict:
    """(c) The packed arm on the one-program backend, f32 and bf16."""
    import dataclasses

    from repro_torch.dist import FakeClock
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, ServingScheduler

    cfg, reqs, max_seq = gemma["cfg"], gemma["reqs"], gemma["max_seq"]
    f32 = mesh_serves(torch, cfg, gemma["params"], reqs, max_seq,
                      gemma["packed"], "mesh f32")
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params16 = M.init_params(
        cfg16, torch.Generator(device="cuda").manual_seed(SEED + 33))
    ex = make_executor(FakeClock())
    try:
        eng = Engine(cfg16, params16, coded=(N_WORKERS, GEMMA_K), executor=ex)
        sched = ServingScheduler(eng, max_seq=max_seq, max_batch=SERVE_BATCH,
                                 master_call_s=SERVE_MASTER_S, packed=True)
        res, pool_wall, _ = serve_once(torch, sched, reqs)
    finally:
        ex.close()
    bf16 = mesh_serves(torch, cfg16, params16, reqs, max_seq, tokens_of(res),
                       "mesh bf16")
    del params16
    emit({"phase": "serving", "part": "c: mesh",
          "setup": "MeshExecutor(dead=(1,), stragglers=(2,)), runs booked "
                   "at the pool's modeled 1.0 s, packed arm",
          "f32": f32, "f32_pool_wall_s": gemma["packed_wall_s"],
          "bf16": bf16, "bf16_pool_wall_s": pool_wall,
          "bf16_pool_steps": step_rows(res)})
    counts = {}
    for part in (f32, bf16):
        for k, v in part["first_launches"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


def phase_serving(torch, z: dict) -> dict:
    """Parts (a) to (c), one JSON line each; returns the counted paths'
    launches."""
    counts_a, gemma = serving_gemma(torch)
    counts_b = serving_zamba2(torch, z)
    counts_c = serving_mesh(torch, gemma)
    return {"serving_gemma": counts_a, "serving_zamba2": counts_b,
            "serving_mesh": counts_c}


# ---------------------------------------------------------------------------
# phase 9: the remaining model families — frontends and routed experts
# ---------------------------------------------------------------------------

# (a) and (b): prefill from synthetic frontend embeddings at full width and
# depth, then greedy decode by token, on the pool, on the mesh and uncoded.
# B = 8 so that every decode step has >= k = 6 tokens and codes its GEMMs
# (a step with fewer runs on the master uncoded, the reference's rule).
# (part, arch, frontend helper, batch, embeddings, decode steps, coded
# GEMMs a layer a step)
FRONTEND_PARTS = (
    # one 448x448 InternVL2 tile after pixel shuffle: 256 patches
    ("a", "internvl2-1b", "synthetic_patches", 8, 256, 16, 3),
    # 10 s of EnCodec frames at 50 Hz
    ("b", "musicgen-medium", "synthetic_frames", 8, 500, 16, 2),
)
FAMILY_K = 6
FAMILY_SERVE = (8, 512, 16)  # (a)'s Engine.generate: prompts, tokens, new
# (c) and (d): the MoE configs at published widths, depth cut
MOE_PARTS = (("c", "dbrx-132b", 2), ("d", "kimi-k2-1t-a32b", 1))
MOE_SERVE = (4, 512, 8)      # prompts, tokens, new tokens each
MOE_F64_TOKENS = {"dbrx-132b": None, "kimi-k2-1t-a32b": 64}
KIMI_PEAK_LIMIT = 45e9


def family_ffn(arch: str) -> tuple:
    """(d_in, d_out) of the frontend model's FFN weights (w_gate shares
    w_in's)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)


def family_t_ps(arch: str) -> tuple:
    """The piece rows t_p = tokens // k of the frontend part's coded GEMMs:
    its prefill, its decode steps and (internvl2-1b) the Engine's prefill."""
    part = next(p for p in FRONTEND_PARTS if p[1] == arch)
    t_ps = [part[3] * part[4] // FAMILY_K, part[3] // FAMILY_K]
    if arch == "internvl2-1b":
        t_ps.append(FAMILY_SERVE[0] * FAMILY_SERVE[1] // FAMILY_K)
    return tuple(sorted(set(t_ps)))


def family_gemm_cases(torch, G106, D66) -> list:
    """The pieces, encodes and decodes of the frontend parts' coded FFNs at
    (10, 6): per t_p and weight (d_in, d_out), the piece ``(t_p, d_in) @
    (d_in, d_out)``, the encode ``(10, 6) @ (6, t_p d_in)`` and the decode
    ``(6, 6) @ (6, t_p d_out)``."""
    f32 = torch.float32
    cases = []
    for _, arch, *_ in FRONTEND_PARTS:
        for t_p in family_t_ps(arch):
            for b, F in family_ffn(arch):
                cases += [
                    (f"piece GEMM {arch} {t_p}x{b}x{F}", (t_p, b), F, f32,
                     False),
                    (f"encode {arch} (10,6)@(6,{t_p}*{b})", G106, t_p * b,
                     f32, False),
                    (f"decode {arch} (6,6)@(6,{t_p}*{F})", D66, t_p * F, f32,
                     False)]
    return cases


def device_profile(torch, fn, top: int = 4, groups: dict | None = None):
    """``fn()`` under torch.profiler, device activity only, read from the
    profiler's raw records (a run launches ~10^5 kernels, and turning every
    record into a Python event costs ~30x this walk): (fn's result, wall
    s, {wall_ms, device_ms, idle_share, top}, device instances by kernel
    name).  ``groups`` ({group: name parts}) adds each group's device ms
    (a kernel in the first group whose part its name holds; the rest
    under "other")."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ns, calls = collections.Counter(), collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and not ev.is_hidden_event():
            ns[ev.name()] += ev.duration_ns()
            calls[ev.name()] += 1
    require(bool(ns), "no device kernel rows in the profile")
    device_ms = sum(ns.values()) / 1e6
    stats = {"wall_ms": wall * 1e3, "device_ms": device_ms,
             "idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
             "top": [{"name": k[:60], "ms": t / 1e6}
                     for k, t in ns.most_common(top)]}
    if groups:
        by = dict.fromkeys(list(groups) + ["other"], 0.0)
        for name, t in ns.items():
            g = next((g for g, parts in groups.items()
                      if any(p in name for p in parts)), "other")
            by[g] += t / 1e6
        stats["groups_ms"] = by
    return out, wall, stats, calls


def instances(calls, part: str) -> int:
    return sum(n for name, n in calls.items() if part in name)


def param_bytes(params) -> int:
    from repro_torch.models.model import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(params))


def embed_run(torch, cfg, params, emb, steps, feed=None):
    """Prefill from the embeddings ``emb`` (B, T, D), then ``steps`` decode
    steps by token: greedy, or ``feed`` (B, steps + 1) teacher-forced.
    Returns (each step's logits (B, vocab), tokens (B, steps + 1), TTFT
    ms, ms per decode step)."""
    import numpy as np
    from repro_torch.models import model as M

    V = cfg.vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, embeds=emb,
                              max_seq=emb.shape[1] + steps)
    out = [logits[:, 0, :V]]
    toks = [out[-1].argmax(-1).cpu().numpy()]
    ttft = time.perf_counter() - t0
    for s in range(steps):
        nxt = toks[-1] if feed is None else feed[:, s]
        logits, cache = M.decode_step(
            cfg, params, cache, token=torch.as_tensor(nxt[:, None],
                                                      device="cuda"))
        out.append(logits[:, 0, :V])
        toks.append(out[-1].argmax(-1).cpu().numpy())
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return out, np.stack(toks, 1), ttft * 1e3, (total - ttft) / steps * 1e3


def as_completions(tokens) -> list:
    """Token rows as the completions ``hold_to_uncoded`` reads."""
    import types

    return [types.SimpleNamespace(rid=i, tokens=t)
            for i, t in enumerate(tokens)]


def frontend_design(torch, cfg, batch, length, steps, gemms, live) -> tuple:
    """Coded runs and skinny-GEMM launches by regime the design implies for
    a prefill of ``batch x length`` embeddings and ``steps`` decode steps
    of ``batch`` tokens: ``gemms`` coded GEMMs a layer a step (every step
    has >= k tokens), each one encode, a piece per live worker (all of them
    compute on the virtual clock) and one decode."""
    import collections

    from repro_torch.kernels.skinny_gemm import piece_plan

    calls = [(batch * length, 1), (batch, steps)]
    runs = gemms * cfg.n_layers * sum(n for _, n in calls)
    by = collections.Counter({"coding": 2 * runs})
    for tokens, n in calls:
        t_p = tokens // FAMILY_K
        plan = piece_plan(t_p, cfg.d_model, cfg.d_ff, torch.float32, True)
        by[plan.regime] += live * gemms * cfg.n_layers * n
    return runs, dict(by)


def regimes(tally) -> dict:
    import collections

    by = collections.Counter()
    for (regime, *_), n in tally.counts.items():
        by[regime] += n
    return dict(by)


def families_frontend(torch, part, arch, helper, batch, length, steps,
                      gemms) -> tuple:
    """(a) / (b): one frontend model at full width and depth, f32, seeded
    random weights, prefilled from synthetic embeddings and decoded on the
    pool, on the mesh and uncoded; for (a) also ``Engine.generate`` of
    token prompts on both backends."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.dist import FakeClock, MeshExecutor
    from repro_torch.models import frontends
    from repro_torch.models import model as M

    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    widths = {"internvl2-1b": (24, 896, 14, 2, 64, 4864, 151655, True),
              "musicgen-medium": (48, 1536, 24, 24, 64, 6144, 2048, False)}
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
             cfg.d_ff, cfg.vocab, cfg.gated) == widths[arch],
            f"{arch} at its published widths and depth")
    seed = SEED + 40 + ord(part)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    emb = getattr(frontends, helper)(
        torch.Generator(device="cuda").manual_seed(seed + 1), batch, length,
        cfg.d_model, torch.float32, device="cuda")
    coded = dataclasses.replace(cfg, coded_n=N_WORKERS, coded_k=FAMILY_K)
    ex = make_executor(FakeClock())
    live = N_WORKERS - len(ex.pool.fault_plan.dead)
    want_runs, want_regimes = frontend_design(torch, cfg, batch, length,
                                              steps, gemms, live)
    mesh = MeshExecutor(dead=(1,), stragglers=(2,))
    label = f"families ({part}) {arch}"
    try:
        # ---- the pool: the counted run, then a profiled one -------------
        reports = []
        ex.on_report = reports.append
        ops = record_coded_ops(ex)
        zero_launch_counters()
        t0 = time.perf_counter()
        with LaunchTally() as tally, M.coded_executor(ex):
            pool, pool_toks, pool_ttft, pool_tok_ms = embed_run(
                torch, coded, params, emb, steps)
        pool_wall = time.perf_counter() - t0
        counts = read_launch_counters()
        del ex.run_op
        ex.on_report = None
        require(ex.run_count == len(reports) == len(ops) == want_runs,
                f"{label}: {ex.run_count} coded runs, the design implies "
                f"{want_runs}")
        require(counts["skinny_gemm"] == sum(tally.counts.values())
                == sum(want_regimes.values())
                and regimes(tally) == want_regimes,
                f"{label}: skinny-GEMM launches {regimes(tally)}, the design "
                f"implies {want_regimes}")
        require(tally.counts == coded_op_design(torch, ops, live),
                f"{label}: launches by shape differ from the coded ops' "
                "design")
        require(counts["piece_gemm_stacked"] == counts["conv2d"]
                == counts["ssd_chunk"] == 0, f"{label}: {counts}")
        tally_covered(torch, tally, label)
        for r in reports:
            require(r.t_complete == 1.0 and 1 not in r.subset
                    and 2 not in r.subset,
                    f"{label}: a coded run waited or used a faulty worker: "
                    f"t_complete {r.t_complete}, subset {r.subset}")
        with M.coded_executor(ex):
            (again, again_toks, _, _), _, pool_prof, _ = device_profile(
                torch, lambda: embed_run(torch, coded, params, emb, steps))
        require(np.array_equal(again_toks, pool_toks)
                and all(torch.equal(a, b) for a, b in zip(again, pool)),
                f"{label}: two pool runs differ")

        # ---- uncoded, teacher-forced on the pool's tokens ----------------
        t0 = time.perf_counter()
        refs, _, ref_ttft, ref_tok_ms = embed_run(torch, cfg, params, emb,
                                                  steps, feed=pool_toks)
        ref_wall = time.perf_counter() - t0
        _, _, ref_prof, _ = device_profile(
            torch, lambda: embed_run(torch, cfg, params, emb, steps,
                                     feed=pool_toks))
        ids = list(range(batch))
        quality = hold_to_uncoded(label, [(ids, length, steps + 1)],
                                  as_completions(pool_toks), pool, refs)

        # ---- the mesh: capture, replay, profiled replay -----------------
        # a graph per (token count, weight): each layer's own weights
        t_ps = {batch * length // FAMILY_K, batch // FAMILY_K}
        want_graphs = gemms * cfg.n_layers * len(t_ps)
        want_programs = len(family_ffn(arch)) * len(t_ps)
        want_inst = {"piece_gemm_stacked": want_runs,
                     "skinny_gemm": 2 * want_runs,
                     "coding_gemm_narrow": 2 * want_runs}
        mesh_rows, attempts = [], []
        # the profiled turn counts the replays' kernels on the device.  The
        # profiler can lose a replay's records (one whole-script run lost 2
        # of 1632 replays' kernels): a shortfall is measured again, up to
        # three profiled runs, and every attempt is reported
        for turn in ("first (captures)", "replayed") + ("profiled",) * 3:
            r0, g0 = mesh.run_count, mesh.graph_count
            zero_launch_counters()
            t0 = time.perf_counter()
            with M.coded_executor(mesh):
                if turn == "profiled":
                    (got, got_toks, ttft, tok_ms), wall, mesh_prof, calls = \
                        device_profile(torch, lambda: embed_run(
                            torch, coded, params, emb, steps))
                else:
                    got, got_toks, ttft, tok_ms = embed_run(
                        torch, coded, params, emb, steps)
                    wall = time.perf_counter() - t0
            wrappers = read_launch_counters()
            require(np.array_equal(got_toks, pool_toks)
                    and all(torch.equal(a, b) for a, b in zip(got, pool)),
                    f"{label} mesh {turn}: tokens or logits are not the "
                    "pool's bit for bit")
            require(mesh.run_count - r0 == want_runs,
                    f"{label} mesh {turn}: {mesh.run_count - r0} runs")
            if turn == "first (captures)":
                require(mesh.graph_count == want_graphs
                        and mesh.compile_count == want_programs
                        and wrappers["piece_gemm_stacked"] == 2 * want_graphs
                        and wrappers["skinny_gemm"] == 4 * want_graphs,
                        f"{label} mesh: {mesh.graph_count} graphs, "
                        f"{mesh.compile_count} programs, wrappers "
                        f"{wrappers}; the design implies {want_graphs} "
                        f"graphs, {want_programs} programs")
            else:
                require(mesh.graph_count == g0 and wrappers["skinny_gemm"]
                        == wrappers["piece_gemm_stacked"] == 0,
                        f"{label} mesh {turn}: captured or called wrappers: "
                        f"{wrappers}")
            mesh_rows.append({"turn": turn, "wall_s": wall, "ttft_ms": ttft,
                              "decode_ms_per_step": tok_ms,
                              "wrapper_calls": wrappers})
            if turn == "profiled":
                attempts.append({
                    "piece_gemm_stacked": instances(calls, "piece_"),
                    "skinny_gemm": instances(calls, "coding_gemm"),
                    "coding_gemm_narrow": instances(calls,
                                                    "coding_gemm_narrow")})
                mesh_rows[-1]["device_instances"] = attempts[-1]
                if attempts[-1] == want_inst:
                    break
        require(attempts[-1] == want_inst,
                f"{label} mesh: device kernel instances {attempts} in "
                f"{want_runs} replayed runs; the design implies {want_inst}")
        mesh_launches = {k: attempts[-1][k]
                         for k in ("piece_gemm_stacked", "skinny_gemm")}

        # ---- (a): token prompts through Engine.generate, both backends ---
        serve = None
        if arch == "internvl2-1b":
            serve = frontend_serve(torch, cfg, params, ex, mesh, live, label)
    finally:
        ex.close()
        mesh.close()
    row = {"phase": "families", "part": f"{part}: {arch}",
           "model": f"{arch} at published widths and depth: "
                    f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
                    f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
                    f"{cfg.d_ff} ({'gated ' if cfg.gated else ''}{cfg.act}), "
                    f"vocab {cfg.vocab}; f32, seeded random weights",
           "input": f"{helper}: B={batch}, {length} embeddings, then "
                    f"{steps} greedy decode steps by token",
           "coded": {"scheme": "mds", "n": N_WORKERS, "k": FAMILY_K,
                     "faults": "dead={1}, straggler={2: 50x}",
                     "pool_clock": "FakeClock + DeterministicDelay(1.0)",
                     "mesh": "MeshExecutor(dead=(1,), stragglers=(2,))"},
           "param_bytes": param_bytes(params),
           "pool": {"wall_s": pool_wall, "ttft_ms": pool_ttft,
                    "decode_ms_per_step": pool_tok_ms,
                    "coded_runs": want_runs,
                    "dispatches": ex.pool.dispatch_count,
                    "skinny_gemm_by_regime": regimes(tally),
                    "launches_by_shape": tally_rows(tally),
                    "profile": pool_prof},
           "mesh": {"turns": mesh_rows, "graphs": mesh.graph_count,
                    "programs": mesh.compile_count,
                    "launches_replayed": mesh_launches,
                    "profiled_attempts": len(attempts),
                    "profile": mesh_prof},
           "uncoded": {"wall_s": ref_wall, "ttft_ms": ref_ttft,
                       "decode_ms_per_step": ref_tok_ms,
                       "profile": ref_prof},
           "design": {"coded_runs": want_runs,
                      "skinny_gemm_by_regime": want_regimes,
                      "mesh_graphs": want_graphs,
                      "mesh_programs": want_programs},
           "pool_vs_uncoded": quality,
           "mesh_vs_pool": "tokens and every step's logits bit for bit",
           "engine": serve,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_part}
    emit(row)
    launches = {"skinny_gemm": counts["skinny_gemm"]
                + mesh_launches["skinny_gemm"]
                + (serve["pool_launches"] if serve else 0),
                "piece_gemm_stacked": mesh_launches["piece_gemm_stacked"]}
    del params, emb
    return launches


def frontend_serve(torch, cfg, params, ex, mesh, live, label) -> dict:
    """(a)'s token prompts through ``Engine.generate`` on the pool and on
    the mesh: logits against the uncoded model, the mesh's tokens and
    logits the pool's bit for bit, coded runs and launches against the
    design."""
    import numpy as np
    from repro_torch.serving import Engine, Request

    n_req, T, new = FAMILY_SERVE
    rng = np.random.default_rng(SEED + 45)
    reqs = [Request(i, rng.integers(0, cfg.vocab, T, dtype=np.int32),
                    max_new=new) for i in range(n_req)]
    buckets = [(list(range(n_req)), T, new)]
    gemms = 3 if cfg.gated else 2
    want_runs = gemms * cfg.n_layers * new  # the prefill and new - 1 steps
    rows = {}
    for name, executor in (("pool", ex), ("mesh", mesh)):
        eng = Engine(cfg, params, coded=(N_WORKERS, FAMILY_K),
                     executor=executor)
        steps = record_steps(eng)
        r0 = executor.run_count
        zero_launch_counters()
        with LaunchTally() as tally:
            t0 = time.perf_counter()
            out = eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        eng._bind_steps()
        require(executor.run_count - r0 == want_runs,
                f"{label} Engine on the {name}: "
                f"{executor.run_count - r0} coded runs, the design implies "
                f"{want_runs}")
        if name == "pool":
            tally_covered(torch, tally, f"{label} Engine")
            require(sum(tally.counts.values()) == want_runs * (2 + live),
                    f"{label} Engine: {sum(tally.counts.values())} "
                    "skinny-GEMM launches")
        ttft, _, per_tok = latency_rows(buckets, {c.rid: c for c in out})
        rows[name] = {"out": out, "steps": steps, "wall_s": wall,
                      "ttft_ms": ttft[T], "decode_ms_per_token": per_tok[T],
                      "coded_runs": want_runs,
                      "launches": read_launch_counters(),
                      "skinny_gemm_by_regime": regimes(tally)}
    pool, mx = rows["pool"], rows["mesh"]
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(pool["out"], mx["out"]))
            and all(torch.equal(a, b)
                    for a, b in zip(pool["steps"], mx["steps"])),
            f"{label} Engine: the mesh's tokens or logits are not the "
            "pool's bit for bit")
    gen = np.stack([c.tokens for c in pool["out"]])
    refs = teacher_forced_refs(torch, cfg, params, reqs, buckets[0][0], T,
                               new, gen)
    quality = hold_to_uncoded(f"{label} Engine", buckets, pool["out"],
                              pool["steps"], refs)
    for r in rows.values():
        del r["out"], r["steps"]
    return {"requests": n_req, "prompt": T, "max_new": new, **rows,
            "pool_vs_uncoded": quality, "pool_launches":
                rows["pool"]["launches"]["skinny_gemm"]}


def moe_mixture_f64(torch, cfg, moe, y) -> dict:
    """``_moe_ffn(cfg, moe, y)`` held against the same mixture in f64 on
    the card, one expert at a time: each expert over the (token, slot)
    pairs ``moe_route`` keeps, weighted by the port's renormalised gates.

    Two holds.  The largest error is within ``8 (u + sqrt(D + F) u32)`` of
    the largest output: at most eight roundings to the model's type along
    the chain (the buffer, h, g, silu(g), silu(g) h, the expert output,
    the gated sum's cast) at u = 2^-8 in bf16 or u32 = 2^-24 in f32, and
    f32 accumulations of depth D and F, whose independent roundings grow
    as sqrt(depth) u32.  And every element is within a bound of the
    port's roundoff to first order, elementwise,
    from the f64 values and the magnitudes of the products: a product of
    depth n accumulated in f32 is off by at most n u32 (|a| |b|), each
    result rounded to the model's type by u |result| (u = u32 = 2^-24 in
    f32, u16 = 2^-8 in bf16), silu's slope is below 1.1, and the errors
    propagate through act(g) * h, the output product and the gated sum
    (K terms in f32, then one rounding to the model's type).  The f32 gates
    are held against gates from f64 logits at 4 D u32 max_e(|y| |router|)
    (softmax and the top-k renormalisation each at most double a logit's
    error)."""
    import torch.nn.functional as F
    from repro_torch.models import model as M

    require(cfg.act == "silu", "the MoE configs use silu experts")
    D, K, Fd = cfg.d_model, cfg.top_k, cfg.d_ff
    u32 = 2.0 ** -24
    u = 2.0 ** -8 if cfg.dtype == torch.bfloat16 else u32
    flat = y.reshape(-1, D)
    got = M._moe_ffn(cfg, moe, y).reshape(-1, D).double()
    gates, eid, pos, keep, C = M.moe_route(cfg, moe["router"], flat)
    y64 = flat.double()
    r64 = moe["router"].double()
    probs = torch.softmax(y64 @ r64, dim=-1)
    g64 = probs.gather(1, eid.view(-1, K))
    g64 = g64 / g64.sum(-1, keepdim=True).clamp(min=1e-9)
    lm = (y64.abs() @ r64.abs()).amax(-1, keepdim=True)
    gate_err = float(((gates.double() - g64).abs()
                      / (4 * D * u32 * lm + 2 * u32)).max())
    require(gate_err <= 1.0, f"MoE gates vs f64: err/tol {gate_err:.3g}")
    slot_g = gates.double().reshape(-1)
    tok = torch.arange(flat.shape[0], device=y.device).repeat_interleave(K)
    want = torch.zeros_like(y64)
    tol = torch.zeros_like(y64)
    for e in range(cfg.n_experts):
        s = ((eid == e) & keep).nonzero()[:, 0]
        if not len(s):
            continue
        t = tok[s]
        xe, ax = y64[t], y64[t].abs()
        w_in, w_gate, w_out = (moe[n][e].double()
                               for n in ("w_in", "w_gate", "w_out"))
        h, g = xe @ w_in, xe @ w_gate
        a = F.silu(g)
        p = a * h
        oe = p @ w_out
        e_h = D * u32 * (ax @ w_in.abs()) + u * h.abs()
        e_a = 1.1 * (D * u32 * (ax @ w_gate.abs()) + u * g.abs()) \
            + u * a.abs()
        e_p = a.abs() * e_h + h.abs() * e_a + u * p.abs()
        e_o = (e_p @ w_out.abs() + Fd * u32 * (p.abs() @ w_out.abs())
               + u * oe.abs())
        gs = slot_g[s, None]
        want.index_add_(0, t, gs * oe)
        tol.index_add_(0, t, gs * (e_o + K * u32 * oe.abs()))
    tol += u * want.abs()
    err = (got - want).abs()
    rel = float(err.max()) / float(want.abs().max())
    rel_tol = 8 * (u + (D + Fd) ** 0.5 * u32)
    require(rel <= rel_tol, f"_moe_ffn vs the f64 mixture: relative error "
                            f"{rel:.3g} > {rel_tol:.3g}")
    ratio = float((err / (tol + 1e-30)).max())
    require(ratio <= 1.0, f"_moe_ffn vs the f64 mixture: err over the "
                          f"first-order bound {ratio:.3g}")
    return {"tokens": flat.shape[0], "capacity": C,
            "dropped_slots": int((~keep).sum()),
            "kept_slots": int(keep.sum()),
            "max_abs_err": float(err.max()), "rel_err": rel,
            "rel_tol": rel_tol, "max_bound": float(tol.max()),
            "err_over_bound": ratio,
            "gates_err_over_tol": gate_err,
            "max_abs_out": float(want.abs().max())}


def moe_input(torch, cfg, params, toks):
    """Layer 0's FFN input at prefill: the attention block's output,
    normed (``_attn_block_full`` up to its FFN)."""
    from repro_torch.models import model as M
    from repro_torch.models.common import rms_norm

    layer = params["layers"][0]
    x = M._embed_in(cfg, params, toks)
    pos = torch.arange(x.shape[1], device=x.device)
    h = x + M._attn_full(cfg, layer["attn"], rms_norm(x, layer["attn_norm"]),
                         pos, cfg.sliding_window)
    return rms_norm(h, layer["ffn_norm"])


class DropTally:
    """Records each ``_moe_ffn`` call's token count, capacity and dropped
    (token, slot) pairs while active."""

    def __enter__(self):
        from repro_torch.models import model as M

        self.calls, self._orig = [], M._moe_ffn

        def counting(cfg, p, x):
            flat = x.reshape(-1, x.shape[-1])
            _, _, _, keep, C = M.moe_route(cfg, p["router"], flat)
            self.calls.append((flat.shape[0], C, int((~keep).sum())))
            return self._orig(cfg, p, x)

        M._moe_ffn = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M

        M._moe_ffn = self._orig

    def summary(self) -> list:
        rows = {}
        for tokens, C, drops in self.calls:
            r = rows.setdefault((tokens, C), [0, 0, 0])
            r[0] += 1
            r[1] += drops
            r[2] = max(r[2], drops)
        return [{"tokens": t, "capacity": c, "calls": n, "dropped": d,
                 "most_in_a_call": m} for (t, c), (n, d, m) in rows.items()]


def families_moe(torch, part, arch, depth) -> None:
    """(c) / (d): one MoE config at its published widths, depth cut, served
    through ``Engine.generate``, its MoE FFN held against an f64 mixture."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.dist import FakeClock
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, Request

    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    if arch == "dbrx-132b":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    widths = {"dbrx-132b": (6144, 48, 8, 128, 10752, 100352, 16, 4,
                            torch.float32),
              "kimi-k2-1t-a32b": (7168, 64, 8, 112, 2048, 163840, 384, 8,
                                  torch.bfloat16)}
    require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
             cfg.vocab, cfg.n_experts, cfg.top_k, cfg.dtype) == widths[arch],
            f"{arch} at its published widths")
    label = f"families ({part}) {arch}"
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 50 + ord(part)), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_req, T, new = MOE_SERVE
    rng = np.random.default_rng(SEED + 51)
    reqs = [Request(i, rng.integers(0, cfg.vocab, T, dtype=np.int32),
                    max_new=new) for i in range(n_req)]
    buckets = [(list(range(n_req)), T, new)]
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]).astype(np.int64),
                           device="cuda")

    # ---- served uncoded: drops per call, then timed, then profiled ------
    eng = Engine(cfg, params)
    zero_launch_counters()
    with DropTally() as drops:
        out = eng.generate(reqs)
    launches = read_launch_counters()  # uncoded: no kernel of the port
    t0 = time.perf_counter()
    timed_out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft, _, per_tok = latency_rows(buckets, {c.rid: c for c in timed_out})
    prof_out, _, prof, _ = device_profile(torch, lambda: eng.generate(reqs))
    tokens = [c.tokens.tolist() for c in out]
    require(all([c.tokens.tolist() for c in o] == tokens
                for o in (timed_out, prof_out)),
            f"{label}: three uncoded serves gave other tokens")

    # ---- coded (10, 6) on the pool: the reference codes no MoE GEMM -----
    coded = None
    if part == "c":
        ex = make_executor(FakeClock())
        try:
            zero_launch_counters()
            ceng = Engine(cfg, params, coded=(N_WORKERS, FAMILY_K),
                          executor=ex)
            cout = ceng.generate(reqs)
            wrappers = read_launch_counters()
            require(ex.run_count == 0 and ex.pool.dispatch_count == 0
                    and not any(wrappers.values()),
                    f"{label}: coded (10, 6) ran {ex.run_count} coded runs, "
                    f"{ex.pool.dispatch_count} dispatches, {wrappers}")
            require([c.tokens.tolist() for c in cout] == tokens,
                    f"{label}: the coded engine served other tokens")
        finally:
            ex.close()
        coded = {"coded_runs": 0, "dispatches": 0, "wrapper_calls": wrappers,
                 "tokens_equal_uncoded": True,
                 "note": "the reference codes only the dense FFN's GEMMs "
                         "(model.py _ffn -> _matmul); _moe_ffn, attention "
                         "and the LM head are einsums there, so a coded MoE "
                         "config runs no coded op"}

    # ---- _moe_ffn on layer 0's prefill input against f64 ----------------
    n64 = MOE_F64_TOKENS[arch]
    y = moe_input(torch, cfg, params, toks if n64 is None
                  else toks[:1, :n64])
    mixture = moe_mixture_f64(torch, cfg, params["layers"][0]["moe"], y)
    del y

    checks = {}
    if part == "c":
        # prefill + decode against forward, with no drops (the reference's
        # test_smoke_prefill_decode_consistency and its bound)
        cfg4 = dataclasses.replace(cfg, capacity_factor=4.0)
        lgp, cache = M.prefill(cfg4, params, toks, max_seq=T + 1)
        nxt = lgp[..., : cfg.vocab].argmax(-1)
        lgd, _ = M.decode_step(cfg4, params, cache, token=nxt)
        full_last = M.forward(cfg4, params, torch.cat([toks, nxt], 1))[:, -1]
        V = cfg.vocab
        scale = float(full_last[:, :V].abs().max()) + 1e-9
        rel = float((lgd[:, 0, :V] - full_last[:, :V]).abs().max()) / scale
        require(rel < 2e-2, f"{label}: prefill + decode vs forward at "
                            f"capacity 4.0: {rel:.3g} >= 2e-2")
        del lgp, cache, lgd, full_last
        # flash_causal_attention against the blockwise attention
        plain = M.forward(cfg, params, toks)[..., :V]
        flash = M.forward(dataclasses.replace(cfg, flash_vjp=True), params,
                          toks)[..., :V]
        ftol = 1e-4 * float(plain.abs().max())
        ferr = float((flash - plain).abs().max())
        require(ferr <= ftol, f"{label}: flash_vjp forward differs by "
                              f"{ferr} > {ftol}")
        del plain, flash
        checks = {"prefill_decode_vs_forward_cf4": {"rel_err": rel,
                                                    "bound": 2e-2},
                  "flash_vs_blockwise": {
                      "T": T, "H": cfg.n_heads, "K": cfg.n_kv_heads,
                      "P": cfg.hd, "max_abs_err": ferr, "tol": ftol}}
    peak = torch.cuda.max_memory_allocated()
    if part == "d":
        require(peak < KIMI_PEAK_LIMIT,
                f"{label}: peak {peak} B >= {KIMI_PEAK_LIMIT:.0f} B")
    emit({"phase": "families", "part": f"{part}: {arch}",
          "model": f"{arch} at published widths (d_model {cfg.d_model}, "
                   f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                   f"{cfg.hd}, {cfg.n_experts} experts top-{cfg.top_k} of "
                   f"d_ff {cfg.d_ff}, vocab {cfg.vocab}), depth "
                   f"{full.n_layers} -> {depth}; "
                   f"{str(cfg.dtype).replace('torch.', '')} (router f32), "
                   "seeded random weights",
          "requests": n_req, "prompt": T, "max_new": new,
          "param_bytes": param_bytes(params), "params": M.param_count(params),
          "init_s": init_s, "init_peak_bytes": init_peak,
          "wall_s": wall, "ttft_ms": ttft[T],
          "decode_ms_per_token": per_tok[T], "profile": prof,
          "launches": launches, "drops_per_call": drops.summary(),
          "coded": coded,
          "moe_vs_f64": mixture, **checks,
          "peak_bytes": peak, "peak_limit": KIMI_PEAK_LIMIT
          if part == "d" else None,
          "seconds": time.perf_counter() - t_part})
    del params, eng


def phase_families(torch) -> dict:
    """Parts (a) to (d), one JSON line each, after releasing every earlier
    phase's model; returns the counted paths' launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "part": "start",
          "memory_allocated": torch.cuda.memory_allocated(),
          "memory_reserved": torch.cuda.memory_reserved()})
    counts = {}
    for spec in FRONTEND_PARTS:
        for k, n in families_frontend(torch, *spec).items():
            counts[k] = counts.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    for spec in MOE_PARTS:
        families_moe(torch, *spec)
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: training — the SSD backward kernel under autograd
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-3  # kernel gradient vs the f64 one, relative to its max
ALL_SSD_PASSES = ("cb", "states", "state_pass", "out", "out_bwd",
                  "state_pass_bwd", "states_bwd", "cb_bwd")


def zero_train_counters() -> None:
    """Every launch counter, the SSD backward's too (only the train
    phase's paths run it)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_bwd

    zero_launch_counters()
    ssd_chunk_scan_bwd.launches = 0
    ssd_chunk_scan_bwd.pass_launches = dict.fromkeys(
        ssd_chunk_scan_bwd.pass_launches, 0)


def read_train_counters() -> dict:
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_bwd

    counts = read_launch_counters()
    counts["ssd_chunk_bwd"] = ssd_chunk_scan_bwd.launches
    counts.update({f"ssd_chunk.{k}": n
                   for k, n in ssd_chunk_scan_bwd.pass_launches.items()})
    return counts


def leaf_names(tree) -> list[str]:
    """Each leaf's name (its last key), in ``tree_leaves`` order."""
    from repro_torch.checkpoint.store import _flatten

    return [k.split("/")[-1].strip("[]'.") for k, _ in _flatten(tree)]


def plain_ssd_chunked(x, dt, A, Bm, Cm, chunk=128, init_state=None):
    """``models.ssm.ssd_chunked`` by the SSD passes' plain versions in f64,
    differentiated by autograd: the oracle's SSD."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_passes_plain

    h0 = None if init_state is None else init_state.double()
    return ssd_chunk_scan_passes_plain(x.double(), dt.double(), A.double(),
                                       Bm.double(), Cm.double(), h0,
                                       min(chunk, x.shape[1]))


def train_grad(torch) -> tuple:
    """(a) Zamba2-1.2B at published widths, depth 6 (the shared block
    after layer 5), f32, B=2 T=512 from ``TokenStream``: one gradient on
    the kernels against the f64 gradient of the plain versions, leaf by
    leaf, and no leaf zero.  Returns (launches, params, grads)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import cross_entropy
    from repro_torch.models import model as M
    from repro_torch.optim import tree_leaves, tree_map

    ssm = sys.modules["repro_torch.models.ssm"]
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=6,
                              dtype=torch.float32)
    require(cfg.has_shared_attn(5) and cfg.d_model == 2048,
            "depth 6 at published widths holds the shared block")
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 30),
        device="cuda")
    tokens, labels = next(iter(TokenStream(vocab=cfg.vocab, batch=2,
                                           seq=512, seed=SEED)))
    tok = torch.from_numpy(tokens).cuda()
    lab = torch.from_numpy(labels).cuda()
    leaves = tree_leaves(params)
    names = leaf_names(params)
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    zero_train_counters()
    t0 = time.perf_counter()
    loss = cross_entropy(M.forward(cfg, params, tok), lab)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    counts = read_train_counters()
    for p in leaves:
        p.requires_grad_(False)
    require(counts["ssd_chunk"] == 6 and counts["ssd_chunk_bwd"] == 6
            and all(counts[f"ssd_chunk.{p}"] == 6 for p in ALL_SSD_PASSES),
            f"(a): 6 SSD forward and 6 backward launches, got {counts}")
    require(counts["skinny_gemm"] == 0, f"(a): uncoded, got {counts}")
    # the oracle: parameters and products in f64, the SSD by its plain
    # passes in f64 (the model's own f32 steps, as in the norms, stay f32)
    p64 = tree_map(lambda p: p.detach().double().requires_grad_(True),
                   params)
    l64 = tree_leaves(p64)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    kernel_ssd = ssm.ssd_chunked
    ssm.ssd_chunked = plain_ssd_chunked
    try:
        t0 = time.perf_counter()
        loss64 = cross_entropy(M.forward(cfg64, p64, tok), lab)
        g64 = torch.autograd.grad(loss64, l64)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
    finally:
        ssm.ssd_chunked = kernel_ssd
    rel = {}
    for n, g, r in zip(names, grads, g64):
        require(bool(torch.isfinite(g).all()), f"(a): {n} non-finite")
        require(float(g.abs().max()) > 0.0, f"(a): the gradient of {n} is "
                                            "zero (a dropped backward)")
        e = float((g.double() - r).abs().max() / r.abs().max())
        rel[n] = max(rel.get(n, 0.0), e)
    worst = max(rel.values())
    require(worst <= TRAIN_TOL, f"(a): worst leaf {max(rel, key=rel.get)} "
                                f"rel err {worst:.3g} > {TRAIN_TOL}")
    loss, loss64 = float(loss.detach()), float(loss64.detach())
    loss_err = abs(loss - loss64) / abs(loss64)
    require(loss_err <= TRAIN_TOL, f"(a): loss {loss} vs f64 {loss64}")
    del p64, l64, g64
    emit({"phase": "train", "part": "a",
          "what": "Zamba2-1.2B at published widths, depth 6 (the shared "
                  "attention block after layer 5), f32, B=2 T=512 "
                  "TokenStream: one gradient on the kernels against the f64 "
                  "gradient of the plain versions",
          "loss": loss, "loss_f64": loss64,
          "loss_rel_err": loss_err, "worst_rel_err": worst,
          "tol_rel": TRAIN_TOL, "rel_err_by_leaf": rel, "launches": counts,
          "leaves": len(leaves), "grad_s": grad_s, "oracle_s": oracle_s,
          "seconds": time.perf_counter() - t_start})
    return counts, params, grads


def train_checkpoint(torch, params, grads) -> None:
    """(c) (a)'s parameters and AdamW state after one step, and a bf16
    leaf, saved and loaded back to the card bit for bit."""
    import shutil

    from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.optim import (adamw_init, adamw_update, tree_leaves,
                                   tree_map)

    t_start = time.perf_counter()
    by_leaf = dict(zip(map(id, tree_leaves(params)), grads))
    params, opt = adamw_update(params,
                               tree_map(lambda p: by_leaf[id(p)], params),
                               adamw_init(params), 3e-4)
    tree = {"params": params, "opt": opt,
            "embed_bf16": params["embed"].to(torch.bfloat16)}
    d = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(d, 1, tree)
        save_s = time.perf_counter() - t0
        npz = os.path.getsize(os.path.join(path, "arrays.npz"))
        t0 = time.perf_counter()
        back = load_checkpoint(d, 1, tree)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(latest_step(d) == 1, "(c): latest_step")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    pairs = list(zip(_flatten(tree), _flatten(back)))
    for (k, a), (k2, b) in pairs:
        require(k == k2 and b.device == a.device and b.dtype == a.dtype
                and torch.equal(a, b), f"(c): {k} does not come back bit "
                                       "for bit")
    emit({"phase": "train", "part": "c",
          "what": "(a)'s params and AdamW state after one step, and a bf16 "
                  "copy of the embedding, saved and loaded back to the card",
          "leaves": len(pairs), "bit_identical": True, "npz_bytes": npz,
          "bf16_leaves": sum(a.dtype == torch.bfloat16 for (_, a), _ in pairs),
          "save_s": save_s, "load_s": load_s,
          "seconds": time.perf_counter() - t_start})


TRAIN_STEPS, TRAIN_B, TRAIN_T = 10, 4, 512


def train_run(torch) -> dict:
    """(b) ``train_loop`` on Zamba2-1.2B at published widths and depth,
    f32, B=4 T=512, 10 steps, base lr 3e-4: the loss falls, 38 SSD forward
    and 38 backward launches a step, no skinny GEMM; then s/step, tokens/s
    and one profiled step's device time.  Returns the run's launches."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype=torch.float32)
    require((cfg.n_layers, cfg.d_model) == (38, 2048), "full Zamba2-1.2B")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_train_counters()
    t0 = time.perf_counter()
    params, losses = train_loop(cfg, steps=TRAIN_STEPS, batch=TRAIN_B,
                                seq=TRAIN_T, base_lr=3e-4, log_every=1,
                                seed=SEED, device="cuda")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = read_train_counters()
    peak = torch.cuda.max_memory_allocated()
    n_params = M.param_count(params)
    require(all(math.isfinite(v) for v in losses), f"(b): losses {losses}")
    require(losses[-1] < losses[0], f"(b): the loss did not fall: {losses}")
    per_step = 38 * TRAIN_STEPS
    require(counts["ssd_chunk"] == per_step
            and counts["ssd_chunk_bwd"] == per_step
            and all(counts[f"ssd_chunk.{p}"] == per_step
                    for p in ALL_SSD_PASSES),
            f"(b): 38 SSD forward and 38 backward launches a step, got "
            f"{counts}")
    require(counts["skinny_gemm"] == 0 and counts["piece_gemm_stacked"] == 0
            and counts["conv2d"] == 0, f"(b): training is uncoded: {counts}")
    # s/step and one profiled step, on the trained params with their own
    # AdamW state (the loop's is gone with it)
    step_fn = make_train_step(cfg, base_lr=3e-4, total_steps=TRAIN_STEPS)
    opt = adamw_init(params)
    stream = iter(TokenStream(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_T,
                              seed=SEED + 1))

    def one_step(i):
        tokens, labels = next(stream)
        batch = {"tokens": torch.from_numpy(tokens).cuda(),
                 "labels": torch.from_numpy(labels).cuda()}
        nonlocal params, opt
        params, opt, loss = step_fn(params, opt, batch, i)
        return float(loss)

    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[1]
    _, _, prof, calls = device_profile(
        torch, lambda: one_step(3), top=8,
        groups={"ssd_bwd": ("ssd_out_bwd", "ssd_state_pass_bwd",
                            "ssd_states_bwd", "ssd_cb_bwd"),
                "ssd_fwd": ("ssd_cb_kernel", "ssd_states_kernel",
                            "ssd_state_pass_kernel", "ssd_out_kernel"),
                "gemm": ("gemm", "Kernel2", "cutlass", "xmma")})
    bwd_rows = {k: instances(calls, k) for k in
                ("ssd_out_bwd", "ssd_state_pass_bwd", "ssd_states_bwd",
                 "ssd_cb_bwd")}
    require(all(n == 38 for n in bwd_rows.values()),
            f"(b): the profiled step ran {bwd_rows} SSD backward kernels")
    emit({"phase": "train", "part": "b",
          "what": "train_loop, Zamba2-1.2B at published widths and depth "
                  "(38 Mamba2 layers, the shared block after every 6th), "
                  "f32, B=4 T=512 TokenStream, 10 steps, base lr 3e-4",
          "params": n_params, "losses": losses, "loop_s": loop_s,
          "step_s": step_s, "step_s_all": times,
          "tokens_per_s": TRAIN_B * TRAIN_T / step_s,
          "profiled_step": prof, "peak_bytes": peak,
          "ssd_bwd_instances": bwd_rows, "launches": counts,
          "seconds": time.perf_counter() - t_start})
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return counts, step_s


FLASH_CASES = (  # T, block, window
    (512, 512, 0), (500, 128, 200))
FLASH_TOL = 1e-4


def train_flash(torch) -> None:
    """(d) The flash backward on the card: one gradient with the custom
    backward at gemma-2b's attention widths (H 8, K 1, P 256), against
    autograd through ``blockwise_causal_attention`` (the same forward),
    in one block of 512 and in blocks of 128 with a ragged T and a
    window; then one gradient of gemma-2b at published widths, depth 1,
    B 2 x T 512, with ``flash_vjp=True`` against ``flash_vjp=False``, leaf
    by leaf."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import cross_entropy
    from repro_torch.models import model as M
    from repro_torch.models.attention import (blockwise_causal_attention,
                                              flash_causal_attention)
    from repro_torch.optim import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    rows = []
    for T, blk, window in FLASH_CASES:
        q = _rand(torch, gen, (2, T, 8, 256), torch.float32)
        k = _rand(torch, gen, (2, T, 1, 256), torch.float32)
        v = _rand(torch, gen, (2, T, 1, 256), torch.float32)
        do = _rand(torch, gen, (2, T, 8, 256), torch.float32)

        def grads(fn):
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*ins)
            g = torch.autograd.grad(out, ins, do)
            torch.cuda.synchronize()
            return out.detach(), g, time.perf_counter() - t0

        out, g, flash_s = grads(lambda a, b, c: flash_causal_attention(
            a, b, c, window, blk, blk))
        ref, r, block_s = grads(lambda a, b, c: blockwise_causal_attention(
            a, b, c, window=window, block_q=blk, block_k=blk))
        require(torch.equal(out, ref), f"(d) T={T}: the forwards differ")
        rel = {n: float((a - b).abs().max() / b.abs().max())
               for n, a, b in zip(("dq", "dk", "dv"), g, r)}
        require(max(rel.values()) <= FLASH_TOL,
                f"(d) T={T} block {blk} window {window}: {rel}")
        rows.append({"T": T, "block": blk, "window": window, "rel_err": rel,
                     "flash_s": flash_s, "blockwise_autograd_s": block_s})
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=1,
                              dtype=torch.float32)
    require((cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (8, 1, 256),
            "(d): gemma-2b's attention widths")
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 32),
        device="cuda")
    tokens, labels = next(iter(TokenStream(vocab=cfg.vocab, batch=2,
                                           seq=512, seed=SEED + 2)))
    tok = torch.from_numpy(tokens).cuda()
    lab = torch.from_numpy(labels).cuda()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    model = {}
    for flash in (True, False):
        c = dataclasses.replace(cfg, flash_vjp=flash)
        loss = cross_entropy(M.forward(c, params, tok), lab)
        model[flash] = (float(loss.detach()),
                        torch.autograd.grad(loss, leaves))
    require(model[True][0] == model[False][0],
            f"(d) gemma-2b: the losses differ: {model[True][0]}, "
            f"{model[False][0]}")
    model_rel = {}
    for n, a, b in zip(leaf_names(params), model[True][1], model[False][1]):
        require(float(b.abs().max()) > 0.0, f"(d) gemma-2b: {n} zero")
        model_rel[n] = float((a - b).abs().max() / b.abs().max())
    require(max(model_rel.values()) <= FLASH_TOL,
            f"(d) gemma-2b, flash_vjp: {model_rel}")
    del params, leaves, model
    emit({"phase": "train", "part": "d",
          "what": "flash_causal_attention's backward (_flash_bwd) at "
                  "gemma-2b's attention widths (H 8, K 1, P 256), f32, B=2, "
                  "against autograd through blockwise_causal_attention; "
                  "gemma-2b at published widths, depth 1, B=2 T=512, one "
                  "gradient with flash_vjp=True against flash_vjp=False",
          "tol_rel": FLASH_TOL, "cases": rows,
          "gemma_2b_depth1_flash_vjp_rel_err_by_leaf": model_rel})


def phase_train(torch) -> tuple:
    """Parts (a) to (d), one JSON line each; returns the counted paths'
    launches and (b)'s s/step."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    counts = {}
    counts["train_grad"], params, grads = train_grad(torch)
    train_checkpoint(torch, params, grads)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    counts["train"], step_s = train_run(torch)
    train_flash(torch)
    return counts, step_s


# ---------------------------------------------------------------------------
# phase 11: the sharded coded forms, n processes on the one card
# ---------------------------------------------------------------------------

SHARDED_NK = (10, 6)
# Zamba2-1.2B's shared-block FFN GEMM: the pool's 682-row piece
SHARDED_MM = (4096, 2048, 8192)
# VGG16's conv2_2 at 224x224: (B, C_I, H, W) of the padded input, C_O, K
SHARDED_CONV = (1, 128, 114, 114, 128, 3)
SHARDED_TIMED = 5
SHARDED_JOIN_S = 240.0


def sharded_rank(rank: int, n: int, store: str, out_dir: str) -> None:
    """One rank of phase ``sharded`` (a spawned process): the sharded coded
    matmul and conv at full width, each run twice (launches counted from
    zero), then timed; rank 0 also holds both against f64.  Writes
    ``rank<r>.json``."""
    import hashlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (ConvSpec, MDSScheme, coded_conv2d_sharded,
                                  coded_matmul_sharded)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        torch.cuda.set_device(0)
        mesh = init_device_mesh("cuda", (n,), mesh_dim_names=("model",))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        T, d_in, d_out = SHARDED_MM
        xm = _rand(torch, gen, (T, d_in), torch.float32)
        wm = _rand(torch, gen, (d_in, d_out), torch.float32, d_in ** -0.5)
        B, C, H, W, C_O, K = SHARDED_CONV
        spec = ConvSpec(c_in=C, c_out=C_O, h_in=H, w_in=W, kernel=K)
        xc = _rand(torch, gen, (B, C, H, W), torch.float32, 0.5)
        wc = _rand(torch, gen, (C_O, C, K, K), torch.float32,
                   (C * K * K) ** -0.5)
        code = MDSScheme.make(*SHARDED_NK)
        ops = {"matmul": (lambda: coded_matmul_sharded(xm, wm, code, mesh),
                          lambda: xm.double() @ wm.double(), d_in),
               "conv2d": (lambda: coded_conv2d_sharded(xc, wc, code, spec,
                                                       mesh),
                          lambda: torch.nn.functional.conv2d(
                              xc.double(), wc.double()), C * K * K)}
        out = {"rank": rank, "device": torch.cuda.current_device()}
        for name, (fn, f64, R) in ops.items():
            dist.barrier()
            zero_launch_counters()
            with LaunchTally() as tally:
                y1 = fn()
                y2 = fn()
                torch.cuda.synchronize()
            counts = read_launch_counters()
            walls = []
            for _ in range(SHARDED_TIMED):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            digest = [hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
                      for y in (y1, y2)]
            rec = {"launches": {k: v for k, v in counts.items() if v},
                   "tally": [[*key, c] for key, c in tally.counts.items()],
                   "sha256": digest, "shape": list(y1.shape),
                   "wall_s": walls}
            if rank == 0:
                want = f64()
                amp = decode_amplification(code, code.default_subset())
                rec["max_abs_err"] = float((y1.double() - want).abs().max())
                rec["tol"] = (amp * R ** 0.5 * 2.0 ** -24
                              * float(want.abs().max()))
                rec["decode_amplification"] = amp
                rec["finite"] = bool(torch.isfinite(y1).all())
            out[name] = rec
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_sharded(torch) -> dict:
    """``coded_matmul_sharded`` and ``coded_conv2d_sharded`` at (n, k) =
    (10, 6), one rank a piece, the n ranks processes that share the one
    card (gloo; NCCL takes one rank a device).  Every rank's y equals rank
    0's bit for bit, two runs equal bit for bit, rank 0 within err/tol of
    f64 (the ``coded_ops`` bound); the encode, piece and decode launches
    of each rank against the design.  Returns the ranks' launches."""
    import multiprocessing
    import shutil

    from repro_torch.kernels import _build

    _build.build_all()  # the ranks load what the parent built
    n, k = SHARDED_NK
    d = os.path.join(ROOT, "build", "sharded")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, n, os.path.join(d, "store"), d))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_JOIN_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(timeout=30)
    require(not hung, f"sharded: ranks {hung} did not finish in "
                      f"{SHARDED_JOIN_S} s")
    require(all(p.exitcode == 0 for p in procs),
            f"sharded: rank exit codes {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(n):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    T, d_in, d_out = SHARDED_MM
    t_p = T // k
    B, C, H, W, C_O, K = SHARDED_CONV
    # the design, per rank per op: encode, piece and decode of the
    # matmul on the skinny GEMM (the remainder rows are the master's
    # library product, as in coded_matmul); the conv's encode and decode
    # on the skinny GEMM, its piece and remainder on the conv kernel
    design = {"matmul": {"skinny_gemm": 3}, "conv2d": {"skinny_gemm": 2,
                                                      "conv2d": 2}}
    rows, launches = {}, {"skinny_gemm": 0, "conv2d": 0}
    held = {(m, b, F) for _, A, F, *_ in gemm_cases(torch)
            for m, b in [A if isinstance(A, tuple) else A.shape]}
    for op in ("matmul", "conv2d"):
        head = ranks[0][op]
        require(head["finite"], f"sharded {op}: non-finite output")
        require(head["max_abs_err"] <= head["tol"],
                f"sharded {op}: err {head['max_abs_err']} > tol "
                f"{head['tol']}")
        require(head["sha256"][0] == head["sha256"][1],
                f"sharded {op}: two runs differ")
        for rk in ranks:
            require(rk[op]["sha256"] == head["sha256"],
                    f"sharded {op}: rank {rk['rank']} differs from rank 0")
            per_op = {kk: v / 2 for kk, v in rk[op]["launches"].items()}
            require(per_op == design[op],
                    f"sharded {op}: rank {rk['rank']} launched {per_op}, "
                    f"design {design[op]}")
            for kk, v in rk[op]["launches"].items():
                launches[kk] += v
            missing = {tuple(t[2:5]) for t in rk[op]["tally"]} - held
            require(not missing, f"sharded {op}: skinny-GEMM shapes no "
                                 f"kernels case holds: {missing}")
        walls = [min(rk[op]["wall_s"]) for rk in ranks]
        rows[op] = {
            "shape": ((T, d_in, d_out) if op == "matmul"
                      else [B, C, H, W, C_O, K]),
            "piece": ([t_p, d_in, d_out] if op == "matmul" else None),
            "max_abs_err": head["max_abs_err"], "tol": head["tol"],
            "err_over_tol": head["max_abs_err"] / head["tol"],
            "decode_amplification": head["decode_amplification"],
            "wall_ms_rank0_median": 1e3 * sorted(
                ranks[0][op]["wall_s"])[len(ranks[0][op]["wall_s"]) // 2],
            "wall_ms_min_over_ranks": 1e3 * min(walls),
            "wall_ms_max_over_ranks": 1e3 * max(walls),
            "launches_per_rank_per_op": {
                kk: v / 2 for kk, v in head["launches"].items()},
            "launches_by_regime_rank0": head["tally"],
            "ranks_bit_identical": True, "runs_bit_identical": True}
    emit({"phase": "sharded", "n": n, "k": k, "ranks": n,
          "what": "coded_matmul_sharded on Zamba2-1.2B's (4096, 2048) @ "
                  "(2048, 8192) and coded_conv2d_sharded on VGG16's "
                  "conv2_2 at 224x224, MDS (10, 6), f32, one rank a "
                  "piece, gloo all-gather of the pieces",
          "note": "the ranks are processes that time-share one card: a "
                  "wall here is no multi-card figure",
          "ops": rows, "seconds": wall})
    return launches


# ---------------------------------------------------------------------------
# phase 12: the dry-run, on the CPU while the card works
# ---------------------------------------------------------------------------

DRYRUN_COMBOS = (("gemma-2b", "decode_32k"), ("zamba2-1.2b", "train_4k"),
                 ("zamba2-1.2b", "decode_32k"))
DRYRUN_JOIN_S = 900.0


def dryrun_job(out_path: str) -> None:
    """The ``dryrun`` phase's work, in a spawned CPU process started before
    the card's phases: ``run_one`` for DRYRUN_COMBOS on the single-pod
    mesh, and the FLOPs and bytes of the ``train`` phase's own step
    (Zamba2-1.2B, f32, B 4 x T 512, no remat) on a 1 x 1 mesh.  Writes one
    JSON object to ``out_path``; raises (a non-zero exit) when a run
    fails."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import (fake_process_group, run_one,
                                           step_metrics)
    from repro_torch.launch.steps import (abstract_opt_state,
                                          abstract_params, input_specs,
                                          make_train_step)

    torch.set_num_threads(1)
    out = {"torch": torch.__version__, "records": []}
    t0 = time.perf_counter()
    for arch, shape in DRYRUN_COMBOS:
        out["records"].append(run_one(arch, shape, verbose=False))
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype=torch.float32)
    shape = InputShape("train_phase", TRAIN_T, TRAIN_B, "train")
    with fake_process_group(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            params = abstract_params(cfg, mesh)
            args = (params, abstract_opt_state(params, mesh),
                    input_specs(cfg, shape, mesh), 0)
        m = step_metrics(make_train_step(cfg, base_lr=3e-4,
                                         total_steps=TRAIN_STEPS), args)
    out["train_step"] = {"flops": m["flops"], "bytes": m["bytes"],
                         "ops": m["ops"]}
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_dryrun():
    """Start :func:`dryrun_job` in a spawned process; returns (process,
    output path)."""
    import multiprocessing

    d = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "dryrun.json")
    if os.path.exists(path):
        os.remove(path)
    proc = multiprocessing.get_context("spawn").Process(
        target=dryrun_job, args=(path,))
    proc.start()
    return proc, path


def phase_dryrun(job, train_step_s, smi: str) -> None:
    """Wait for the dry-run process and print its records, one line each,
    and the ``train`` step's roofline share at the card's f32 peak (TF32
    off) and HBM bandwidth."""
    proc, path = job
    proc.join(timeout=DRYRUN_JOIN_S)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=30)
        raise Failed(f"dryrun: the CPU run did not finish in "
                     f"{DRYRUN_JOIN_S} s")
    require(proc.exitcode == 0, f"dryrun: the CPU run exited "
                                f"{proc.exitcode}")
    with open(path) as f:
        res = json.load(f)
    for rec in res["records"]:
        require(0.0 < rec["useful_ratio"] <= 1.0 and rec["hlo_flops"] > 0,
                f"dryrun: {rec['arch']} x {rec['shape']}: {rec}")
        emit({"phase": "dryrun", "torch": res["torch"], **rec})
    ts = res["train_step"]
    line = {"phase": "dryrun", "part": "train_step_roofline",
            "what": "the train phase's step (Zamba2-1.2B, f32, B 4 x T "
                    "512, no remat) counted on a 1 x 1 mesh: matmul "
                    "FLOPs, and operand plus result bytes of its ops as "
                    "the CPU's plain versions run them",
            "flops": ts["flops"], "bytes": ts["bytes"],
            "dryrun_seconds": res["seconds"], "nvidia_smi": smi}
    if train_step_s is not None:
        line.update({
            "step_s": train_step_s,
            "flops_share_of_f32_peak": ts["flops"] / train_step_s
            / PEAK_FLOPS["float32"],
            "bytes_share_of_hbm": ts["bytes"] / train_step_s
            / PEAK_BYTES_PER_S})
    emit(line)


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
# its backward (the reference differentiates the plain jnp ssd_chunked at
# src/repro/models/ssm.py:85; it has no backward kernel), whole and by pass
KERNEL_META["ssd_chunk_bwd"] = {
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
    "replaces": "src/repro/kernels/ssd_scan.py:66"}
KERNEL_META.update({
    f"ssd_chunk.{p}": dict(KERNEL_META["ssd_chunk_bwd"])
    for p in ("out_bwd", "state_pass_bwd", "states_bwd", "cb_bwd")})


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
    for p in ("zamba2_mesh", "adaptive", "serving"):
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

    # the dry-run works on the CPU while the card runs the other phases
    dryrun = start_dryrun() if "dryrun" in phases else None
    # the yardsticks and the plain versions run in full f32 on the card,
    # and bf16 products accumulate in f32, as the reference's do
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"chip_smoke: phase {name} took {seconds[name]} s",
              file=sys.stderr, flush=True)
        return out

    device = timed("device", phase_device, torch) \
        if "device" in phases else None
    cases = timed("kernels", phase_kernels, torch) \
        if "kernels" in phases else None
    if "coded_ops" in phases:
        timed("coded_ops", phase_coded_ops, torch)
    if "mesh_async" in phases:
        timed("mesh_async", phase_mesh_async, torch)
    by_path, zamba2 = {}, None
    if "vgg16" in phases:
        by_path["vgg16"] = timed("vgg16", phase_vgg16, torch)
    if "zamba2" in phases:
        by_path["zamba2"], zamba2 = timed("zamba2", phase_zamba2, torch)
    if "zamba2_mesh" in phases:
        by_path["zamba2_mesh"] = timed("zamba2_mesh", phase_zamba2_mesh,
                                       torch, zamba2)
    if "adaptive" in phases:
        by_path.update(timed("adaptive", phase_adaptive, torch, zamba2))
    if "serving" in phases:
        by_path.update(timed("serving", phase_serving, torch, zamba2))
    if "families" in phases:
        zamba2 = None  # the earlier phases' model: released first
        by_path["families"] = timed("families", phase_families, torch)
    train_step_s = None
    if "train" in phases:
        zamba2 = None
        counts, train_step_s = timed("train", phase_train, torch)
        by_path.update(counts)
    if "sharded" in phases:
        by_path["sharded"] = timed("sharded", phase_sharded, torch)
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun, dryrun, train_step_s,
              nvidia_smi_line())

    if set(phases) != set(ALL_PHASES):
        print(f"partial run ({phases}): no result line", file=sys.stderr)
        return 0
    emit(kernels_line(cases, by_path))
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1),
          "phase_seconds": seconds})
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
    finally:
        import multiprocessing

        for child in multiprocessing.active_children():  # the dry-run's
            child.kill()
            child.join(timeout=30)
