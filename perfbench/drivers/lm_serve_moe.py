"""A hybrid mixture-of-experts language model (``HybridMoEConfig``: Mamba2
and attention mixers, each layer followed by a dropless routed mixture of
the experts this chip holds and a coded shared expert) served under
open-loop traffic by the program's continuous-batching scheduler.

The serve, its end-to-end metric (prompt and output tokens over the host's
wall time of the whole serve), the traced pass and the check after the
window are ``lm_serve``'s (that module's docstring).  What differs:

* Set-up warms each coded token count through every layer's shared-expert
  weights (each layer has its own, so each has its own CUDA graphs on the
  one-program backend), then a prefill of each prompt length and a decode
  step at each batch size, which compiles the grouped GEMM's variants.
  ``MeshExecutor.graph_count`` is read before and after the timed serve,
  and ``correct`` is false if it moved: nothing is captured in the window.
* The program's mixture-of-experts counters (``Engine.moe_counters``) are
  read before and after the timed serve; the rows its held experts
  computed, the largest group and the dropped slots (which must be 0) go
  to the readers.  In the traced pass the counters keep each profiled
  layer call's expert offsets (on the card, read after the profile): its
  three grouped-GEMM calls' group sizes, for the kernel's roofline.
* ``matrix_flops`` counts this model's projections, and the routed rows
  the held experts computed in the traced calls, from the counters.

The reference counts the routings whose 10th and 11th scores lie within
its ``TIE``: the count goes to standard error, beside the check."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchlib import program
from benchlib import traffic as tr
from benchlib.trace import Tracer

from drivers.lm_serve import (CallLog, Enough, Obs, check_sample, judge,
                              position_logits, served_summary)


class MoECallLog(CallLog):
    """``CallLog``, which also reads the held experts' rows computed when
    the profiled block starts and when it ends (outside the profile), and
    has the program's counters keep each profiled layer call's offsets."""

    def __init__(self, engine, tracer, lo, hi):
        super().__init__(engine, tracer, lo, hi)
        self.moe = engine.moe_counters
        self.rows = [0, 0]
        self.offsets: list = []

    def _call(self, kind, shape, fn, *args):
        if self.armed and len(self.calls) == self.lo:
            self.rows[0] = self.moe.read()["rows"]
            self.moe.offsets = self.offsets
        try:
            return super()._call(kind, shape, fn, *args)
        except Enough:
            self.moe.offsets = None
            self.rows[1] = self.moe.read()["rows"]
            raise


def matrix_flops(cfg: dict, ref, kind: str, rows: int, T: int) -> float:
    """The plain model's matrix FLOPs of one model call, the routed
    experts left out (``routed_flops`` counts them from the rows the held
    experts computed): the Mamba2 and attention projections, the router
    and the shared expert at every position, the LM head where it is taken
    (a prefill's last position, each decode lane), and a prefill's causal
    attention products.  The SSD's own arithmetic and a decode step's
    attention over its cache are left out: a lower bound of the work."""
    m = cfg["model"]
    d = ref.dims(m)
    n_attn = sum(t == "attn" for t in m["layer_types"])
    n_mamba = m["n_layers"] - n_attn
    mamba = 2.0 * d["D"] * d["in_proj"] + 2.0 * d["di"] * d["D"]
    attn = (2.0 * d["D"] * (d["Ha"] + 2 * d["K"]) * d["hd"]
            + 2.0 * d["Ha"] * d["hd"] * d["D"])
    ffn = 2.0 * d["D"] * d["E"] + 3 * 2.0 * d["D"] * d["Fs"]
    per_token = n_mamba * mamba + n_attn * attn + m["n_layers"] * ffn
    head = 2.0 * d["D"] * d["V"]
    if kind == "decode":
        return rows * (per_token + head)
    causal = n_attn * rows * 4.0 * d["Ha"] * d["hd"] * T * (T + 1) / 2
    return rows * T * per_token + rows * head + causal


def routed_flops(cfg: dict, rows: int) -> float:
    """The held experts' three projections over ``rows`` routed rows."""
    m = cfg["model"]
    return rows * 3 * 2.0 * m["d_model"] * m["d_ff"]


def warm(engine, backend, cfg: dict, mix: dict, params: dict, max_seq: int,
         max_batch: int, dev) -> int:
    """Run every shape the mix can produce once (see the module's
    docstring); returns the coded token counts warmed."""
    from repro_torch.core.coded_linear import coded_matmul
    from repro_torch.core.schemes import get_scheme
    from repro_torch.serving.engine import cache_take

    coded = cfg["coded"]
    code = get_scheme(coded["scheme"]).make(int(coded["workers"]),
                                            int(coded["k"]))
    lengths = sorted(tr.LengthDist.from_json(mix["prompt_len"]).values)
    counts = sorted({b * T for b in range(1, max_batch + 1) for T in lengths}
                    | set(range(1, max_batch + 1)))
    counts = [tc for tc in counts if tc >= code.k]  # fewer: the master's
    for layer in params["layers"]:
        ffn = layer["shared"]
        D, F = ffn["w_in"].shape
        for tc in counts:
            x = torch.zeros((tc, D), device=dev)
            for w in (ffn["w_in"], ffn["w_gate"]):
                coded_matmul(x, w, code, executor=backend)
            coded_matmul(torch.zeros((tc, F), device=dev), ffn["w_out"],
                         code, executor=backend)
    rng = np.random.default_rng(0)
    V = cfg["model"]["vocab"]
    with engine.executor_ctx():
        for T in lengths[1:]:
            engine.prefill_batch(rng.integers(0, V, (1, T)), max_seq)
        toks, cache = engine.prefill_batch(
            rng.integers(0, V, (max_batch, lengths[0])), max_seq)
        for B in range(max_batch, 0, -1):
            toks, cache = engine.decode_batch(
                cache_take(cache, list(range(B))), toks[:B])
    return len(counts)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    # the program's hybrid configuration first: a program without it
    # stops here, before anything is built
    from repro_torch.models.model import HybridMoEConfig

    cfg, mix, wl, ref = cell.config, cell.traffic, cell.workload, cell.reference
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import ServingScheduler

    m = dict(cfg["model"], dtype=getattr(torch, cfg["model"]["dtype"]),
             layer_types=tuple(cfg["model"]["layer_types"]))
    mcfg = HybridMoEConfig(**m)
    coded = cfg["coded"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = ref.make_params(cfg, gen, dev)
    reqs = tr.open_loop(mix, seconds, seed, mcfg.vocab)
    max_batch = int(wl["max_batch"])
    max_seq = (tr.LengthDist.from_json(mix["prompt_len"]).max_value
               + tr.LengthDist.from_json(mix["max_new"]).max_value)
    backend = program.backend(cfg, wl["backend"])
    engine = Engine(mcfg, params=params,
                    coded=(int(coded["workers"]), int(coded["k"])),
                    scheme=coded["scheme"], max_batch=max_batch,
                    executor=backend, device=dev)
    tracer = Tracer(torch, trace)
    tracer.warm()
    lo, hi = wl["trace_calls"]
    calls = MoECallLog(engine, tracer, lo, hi)
    ops: list = []
    run_op = backend.run_op

    def logged_run_op(op):
        if tracer.active:
            ops.append((op.kind, op.scheme.n, tuple(op.x.shape),
                        tuple(op.w.shape)))
        return run_op(op)

    backend.run_op = logged_run_op
    warm(engine, backend, cfg, mix, params, max_seq, max_batch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    del calls.calls[:]
    reports: list = []
    backend.on_report = reports.append
    sched = ServingScheduler(engine, max_seq=max_seq, max_batch=max_batch,
                             policy=wl["policy"])
    requests = [Request(r.rid, r.prompt, r.max_new, r.arrival_s)
                for r in reqs]
    graphs0 = getattr(backend, "graph_count", 0)
    moe0 = engine.moe_counters.read()
    setup_s = time.perf_counter() - t_start

    w0 = time.perf_counter()
    res = sched.serve(requests)
    serve_s = time.perf_counter() - w0
    moe1 = engine.moe_counters.read()
    graphs1 = getattr(backend, "graph_count", 0)
    walls = [r.wall_s for r in reports]
    backend.on_report = None
    served_calls = list(calls.calls)
    if trace:  # the profiled pass: the same requests, a block of calls
        del calls.calls[:]
        calls.armed = True
        try:
            ServingScheduler(engine, max_seq=max_seq, max_batch=max_batch,
                             policy=wl["policy"]).serve(requests)
        except Enough:
            pass
    tracer.collect()
    sizes = []
    if calls.offsets:  # one copy of every traced layer call's offsets
        D, Fd = mcfg.d_model, mcfg.d_ff
        for o in torch.stack(calls.offsets).cpu():
            g = np.diff(o.numpy()).tolist()
            sizes += [(D, Fd, g), (D, Fd, g), (Fd, D, g)]
    del calls.offsets[:]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    recs = res.records
    traced_flops = sum(matrix_flops(cfg, ref, k, rows, T)
                       for k, rows, T, t in calls.calls if t)
    traced_flops += routed_flops(cfg, calls.rows[1] - calls.rows[0])
    moe = {k: moe1[k] - moe0[k] for k in ("calls", "tokens", "rows",
                                          "dropped")}
    moe.update(max_group=moe1["max_group"], held=mcfg.experts_held)
    obs = Obs(trace=tracer.data, records=recs, steps=res.steps,
              calls=served_calls, run_walls_s=walls, traced_ops=ops,
              traced_flops=traced_flops, dtype=cfg["dtype"], serve_s=serve_s,
              moe=moe, expert_gemms=sizes, graphs_in_window=graphs1 - graphs0)
    got = {c.rid: np.asarray(c.tokens) for c in res.completions}
    failed = sum(1 for r in reqs
                 if r.rid not in got or len(got[r.rid]) != r.max_new)

    # the program's state goes before the reference runs
    backend.close()
    del sched, engine, backend, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = check_sample(reqs, got, int(wl["check_requests"]), seed)
    limit = float(wl["checks"]["logit_gap"])
    ties: list = []
    checks = [{"name": "logit_gap", "limit": limit, "value": widest_gap(
        cfg, ref, params, reqs, got, sample, dev, ties=ties)},
        {"name": "graphs_in_window", "limit": 0,
         "value": graphs1 - graphs0},
        {"name": "dropped_slots", "limit": 0, "value": moe["dropped"]}]
    positions = sum(len(reqs[rid].prompt) + len(got[rid]) - 1
                    for rid in sample)
    print(f"routing near ties (10th and 11th scores within {ref.TIE}): "
          f"{sum(ties)} of {positions * cfg['model']['n_layers']} "
          f"(position, layer) routings in the check", file=sys.stderr,
          flush=True)
    print(f"served: {served_summary(reqs, got)}; moe: {moe}",
          file=sys.stderr, flush=True)
    extra = {}
    if control:  # the float8 reference in the program's place
        ctl = [{"name": "logit_gap", "limit": limit, "value": widest_gap(
            cfg, ref, params, reqs, got, sample, dev, control=True)}]
        extra = {"control": {"checks": ctl, "correct": judge(ctl, 0)},
                 "served": served_summary(reqs, got)}
    tokens = sum(r.prompt_len + r.n_tokens for r in recs)
    return {**extra, "e2e": {"tokens_per_s": tokens / serve_s,
                             "setup_s": setup_s},
            "obs": obs, "attempted": len(reqs), "failed": failed,
            "correct": judge(checks, failed), "checks": checks,
            "device": {"memory_peak_bytes": int(peak)}}


def widest_gap(cfg, ref, params, reqs, got, sample, dev,
               control: bool = False, ties: list | None = None) -> float:
    """``lm_serve.widest_gap``, with the reference's near ties counted
    into ``ties``."""
    worst = 0.0
    for rid in sample:
        toks, prompt = got[rid], reqs[rid].prompt
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(toks[:-1], np.int64)])
        x = torch.as_tensor(seq, device=dev)[None]
        logits = ref.forward(cfg, params, x, last=len(toks), ties=ties)[0]
        if control:
            idx = position_logits(cfg, ref, params, prompt, toks, dev,
                                  quant=True).argmax(-1)
        else:
            idx = torch.as_tensor(toks, dtype=torch.long,
                                  device=logits.device)
        served = logits.gather(1, idx[:, None])[:, 0]
        worst = max(worst, float((logits.max(-1).values - served).max()))
    return worst
