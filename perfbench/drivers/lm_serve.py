"""A language model served under open-loop traffic by the program's
continuous-batching scheduler.

The end-to-end metric is the tokens served per second: every request's
prompt and output tokens over the host's wall time of the whole serve,
from the first arrival to the last token, the scheduler's own work
between model calls included.  The mix sends its requests faster than
the system serves them, so the queue holds work from the first arrival
to the last and the rate is the system's; the requests' time to first
token and time per output token, which then swing with the queue, are
per-layer metrics.

The program under test is ``repro_torch``'s ``Engine`` with its FFN GEMMs
coded on one of the program's backends (``benchlib/program.py``), behind
``ServingScheduler``.  Requests arrive on the mix's schedule; the
scheduler's timeline advances by each model call's wall time and jumps
over idle stretches, so a request's time to first token counts its wait
in the queue.  Every model call's sampled tokens are copied to the host,
which waits for its work on the card.

A traced run serves the window unprofiled first, and takes every
host-clock reading (the requests' and steps' records, the coded runs'
walls, the calls' shapes) from that serve.  It then serves the same
requests again with the profiler on over a fixed block of model calls,
stops at the block's end, and reduces the profile after that: the
profiler's cost lands in no reading of the scheduler or the model.

Set-up warms every shape the mix can produce: each coded GEMM's token
count (a prefill of b prompts of one length, b up to ``max_batch``; a
decode step of up to ``max_batch`` lanes) is run once through the
program's ``coded_matmul`` on the shared block's weights, which captures
its CUDA graphs, and the model runs a prefill of each prompt length and a
decode step at each batch size.  Nothing is captured in the window.

After the window a sample of the finished requests, drawn from the seed
with the longest prompt and the longest output in it, is held to the
plain reference: the reference runs once over each prompt followed by its
served tokens, and the widest gap by which a served token's logit lies
below the reference's best at its position is compared."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchlib import program
from benchlib import traffic as tr
from benchlib.trace import Tracer


class Obs:
    """What the per-layer readers read (``metrics/*.py``)."""

    kind = "lm"

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Enough(Exception):
    """Ends the profiled pass once its block of calls is traced."""


class CallLog:
    """The benchmark's own spans around the engine's model calls: counts
    them, logs each one's kind and shape, and when armed starts the
    profiler at call ``lo``, stops it after call ``hi`` and ends the
    serve there by raising ``Enough``."""

    def __init__(self, engine, tracer: Tracer, lo: int, hi: int):
        self.tracer, self.lo, self.hi = tracer, lo, hi
        self.calls: list = []   # (kind, rows, tokens a row, traced)
        self.armed = False
        prefill, decode = engine.prefill_batch, engine.decode_batch
        engine.prefill_batch = lambda prompts, max_seq: self._call(
            "prefill", np.shape(prompts), prefill, prompts, max_seq)
        engine.decode_batch = lambda cache, tokens: self._call(
            "decode", (len(tokens), 1), decode, cache, tokens)

    def _call(self, kind, shape, fn, *args):
        if self.armed and len(self.calls) == self.lo:
            self.tracer.start()
        traced = self.tracer.active
        with self.tracer.span(f"engine.{kind}_batch"):
            out = fn(*args)
        self.calls.append((kind, int(shape[0]), int(shape[1]), traced))
        if self.armed and len(self.calls) == self.hi:
            self.tracer.stop()
            raise Enough
        return out


def matrix_flops(cfg: dict, ref, kind: str, rows: int, T: int) -> float:
    """The plain model's matrix FLOPs of one model call: every projection
    and the LM head at the positions it is taken (a prefill's last, each
    decode lane), and a prefill's causal attention products.  The SSD's
    own arithmetic and a decode step's attention over its cache are left
    out, so this is a lower bound of the work."""
    m = cfg["model"]
    d = ref.dims(m)
    n_shared = sum(ref.has_shared(m, i) for i in range(m["n_layers"]))
    mamba = 2.0 * d["D"] * d["in_proj"] + 2.0 * d["di"] * d["D"]
    attn = (2.0 * d["D"] * (d["Ha"] + 2 * d["K"]) * d["hd"]
            + 2.0 * d["Ha"] * d["hd"] * d["D"])
    ffn = (3 if m.get("gated", True) else 2) * 2.0 * d["D"] * d["F"]
    per_token = m["n_layers"] * mamba + n_shared * (attn + ffn)
    head = 2.0 * d["D"] * d["V"]
    if kind == "decode":
        return rows * (per_token + head)
    causal = n_shared * rows * 4.0 * d["Ha"] * d["hd"] * T * (T + 1) / 2
    return rows * T * per_token + rows * head + causal


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
    ffn = params["shared_attn"]["ffn"]
    D, F = ffn["w_in"].shape
    for tc in counts:
        if tc < code.k:  # the master computes it uncoded
            continue
        x = torch.zeros((tc, D), device=dev)
        for w in (ffn["w_in"], ffn.get("w_gate")):
            if w is not None:
                coded_matmul(x, w, code, executor=backend)
        coded_matmul(torch.zeros((tc, F), device=dev), ffn["w_out"], code,
                     executor=backend)
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
    return sum(tc >= code.k for tc in counts)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    cfg, mix, wl, ref = cell.config, cell.traffic, cell.workload, cell.reference
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    from repro_torch.models.model import ModelConfig
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import ServingScheduler

    m = dict(cfg["model"], dtype=getattr(torch, cfg["model"]["dtype"]))
    mcfg = ModelConfig(**m)
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
    calls = CallLog(engine, tracer, lo, hi)
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
    setup_s = time.perf_counter() - t_start

    w0 = time.perf_counter()
    res = sched.serve(requests)
    serve_s = time.perf_counter() - w0
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
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    recs = res.records
    traced_flops = sum(matrix_flops(cfg, ref, k, rows, T)
                       for k, rows, T, t in calls.calls if t)
    obs = Obs(trace=tracer.data, records=recs, steps=res.steps,
              calls=served_calls, run_walls_s=walls, traced_ops=ops,
              traced_flops=traced_flops, dtype=cfg["dtype"], serve_s=serve_s)
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
    checks = [{"name": "logit_gap", "limit": limit, "value": widest_gap(
        cfg, ref, params, reqs, got, sample, dev)}]
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


def judge(checks: list, failed: int) -> bool:
    """``correct``: every answer came, and every number is within its
    limit."""
    return failed == 0 and all(c["value"] <= c["limit"] for c in checks)


def check_sample(reqs, got: dict, size: int, seed: int) -> list:
    """The finished requests held to the reference: ``size`` drawn from
    the seed, plus the longest prompt's and the longest output's."""
    done = [r for r in reqs if r.rid in got]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = {int(i) for i in rng.choice([r.rid for r in done],
                                       size=min(size, len(done)),
                                       replace=False)}
    pick.add(max(done, key=lambda r: (len(r.prompt), -r.rid)).rid)
    pick.add(max(done, key=lambda r: (len(got[r.rid]), -r.rid)).rid)
    return sorted(pick)


def position_logits(cfg, ref, params, prompt, tokens, dev, quant=False):
    """The reference's logits at the positions that predicted ``tokens``
    after ``prompt``: (len(tokens), vocab)."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:-1], np.int64)])
    x = torch.as_tensor(seq, device=dev)[None]
    return ref.forward(cfg, params, x, last=len(tokens), quant=quant)[0]


def widest_gap(cfg, ref, params, reqs, got, sample, dev,
               control: bool = False) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, over the sampled requests.  With
    ``control`` the float8 reference's first choice at each of the same
    positions stands in the program's place."""
    worst = 0.0
    for rid in sample:
        toks, prompt = got[rid], reqs[rid].prompt
        logits = position_logits(cfg, ref, params, prompt, toks, dev)
        if control:
            idx = position_logits(cfg, ref, params, prompt, toks, dev,
                                  quant=True).argmax(-1)
        else:
            idx = torch.as_tensor(toks, dtype=torch.long,
                                  device=logits.device)
        served = logits.gather(1, idx[:, None])[:, 0]
        worst = max(worst, float((logits.max(-1).values - served).max()))
    return worst


def served_summary(reqs, got: dict) -> dict:
    """How varied the served tokens are: distinct ids, and the share of
    tokens that repeat the token before them (an echo would make a greedy
    check easy to pass)."""
    toks, repeats, total = set(), 0, 0
    for r in reqs:
        seq = [int(r.prompt[-1])] + [int(t) for t in got.get(r.rid, [])]
        toks.update(seq[1:])
        repeats += sum(a == b for a, b in zip(seq, seq[1:]))
        total += len(seq) - 1
    return {"distinct": len(toks), "tokens": total,
            "repeat_share": repeats / max(total, 1)}
