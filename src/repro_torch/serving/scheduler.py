"""Continuous-batching scheduler: serve open-loop traffic (the port of
``repro.serving.scheduler``; the reference's DESIGN.md §10).

``Engine.generate`` owns one closed batch; this module puts a real serving
loop in front of it.  Requests *arrive* (``Request.arrival_s``, stamped by
:mod:`repro_torch.serving.traffic`), wait in an admission queue, **join** the
running decode batch the step after they arrive (join-at-prefill: the
prefill that admits a lane also emits its first token) and **leave** it at
EOS/``max_new`` — so the batch composition changes every step instead of
draining to the slowest request, and per-request latency is accounted from
*arrival*, not from whenever a closed batch happened to start.

The payoff for coded inference is **batched coded dispatch**: the step's
decode stacks every lane's token into one (B, d) GEMM, so a coded engine
issues ONE n-piece pool dispatch per GEMM covering all B co-scheduled
requests — n pieces per step, not B·n (and a single request's decode
token, B=1 < k, could not even reach the pool: batching is what buys
decode-time straggler protection at all).  The claim is *proved on real
runs*, not asserted from the plan: every step snapshots
``WorkerPool.dispatch_count`` / ``CodedExecutor.run_count`` deltas into
its :class:`StepRecord`.

Two time planes, mirroring the pool (dist/clock.py):

* **virtual** — the engine's executor runs on a ``FakeClock``: each model
  call costs the sum of its pool runs' (virtual) completion times plus
  ``master_call_s``, and the scheduler advances its own deterministic
  timeline by exactly that.  Arrivals, queueing, TTFT percentiles, goodput:
  all bit-reproducible functions of the seeds.
* **measured** — no executor (or a ``RealClock`` pool, or the mesh): each
  call costs its wall-clock time on the same relative timeline.  Real, but
  not deterministic; tests use virtual.  Every engine call returns its
  sampled tokens as host numpy, and that copy waits for the call's device
  work, so a call's wall time covers its work on the card.  Each
  :class:`StepRecord` also takes this plane's own counters: the host's
  waits on the card, the scheduler's host work between calls, and the
  step's prefill calls and tokens.  While a torch profiler records, a step
  is a ``repro.serve.step`` span holding ``repro.serve.admit``,
  ``repro.serve.join`` (the caches' concatenation and selection) and
  ``repro.serve.retire`` ones beside the engine's calls.

Prefill is the other half of the latency story (DESIGN.md §14), and three
opt-outable mechanisms attack it:

* **prefill packing** (``packed``, on by default when the architecture
  supports it) — co-admitted prompts of *mixed* lengths prefill in ONE
  padded, masked call instead of one call per distinct length, so a step's
  admission costs n coded pieces per GEMM total, never per length bucket;
* **chunked prefill** (``chunk_tokens``) — prompts longer than the chunk
  size prefill as a *stream*, one chunk per scheduler step interleaved
  with the running batch's decode, bounding every step's pool occupancy
  (and thus decode TPOT) by the chunk size instead of the longest prompt;
* **coded prefix caching** (``prefix_cache``) — admission looks the prompt
  up in a :class:`~repro.serving.prefix_cache.PrefixCache`; matched
  blocks' KV restore straight into the lane and their coded GEMMs are
  never dispatched (counted on the pool's own counters), only the
  unmatched suffix prefills.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from ..dist.faults import ChurnSchedule, StragglerDrift
from ..telemetry.trace import span
from .engine import Completion, Engine, Request, cache_cat, cache_take
from .prefix_cache import PrefixCache

__all__ = ["RequestRecord", "StepRecord", "ServeResult", "ServingScheduler"]

POLICIES = ("fcfs", "shortest_prompt")


@dataclasses.dataclass
class RequestRecord:
    """One request's life: arrival -> admission -> first token -> done.
    All timestamps on the scheduler's timeline (virtual seconds)."""

    rid: int
    prompt_len: int
    max_new: int
    arrival_s: float
    admit_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    n_tokens: int = 0

    @property
    def ttft_s(self) -> float:
        """Time to first token, from arrival (queue wait included)."""
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> float:
        """Arrival -> last token."""
        return self.done_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (0 for 1-token requests)."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.done_s - self.first_token_s) / (self.n_tokens - 1)


@dataclasses.dataclass
class StepRecord:
    """One co-scheduled step: who ran, what it cost, what the pool did."""

    step: int
    t_start: float
    t_end: float
    batch: int          # lanes decoded this step (after admission)
    admitted: int       # requests prefilled into the batch this step
    retired: int        # lanes that finished this step
    queue_depth: int    # arrived-but-not-admitted after this step's admission
    dispatches: int     # pool pieces dispatched during the step (counter delta)
    runs: int           # executor runs issued during the step (counter delta)
    prefill_dispatches: int = 0  # of `dispatches`, issued by admission prefills
    prefill_runs: int = 0        # of `runs`, issued by admission prefills
    # master-side seconds of the step's model calls (encode/decode/sampling
    # — everything the pool never sees).  Closes the attribution gap for
    # steps that issue ZERO pool runs (all-hot prefix-cache admission, B=1
    # decode): they record span_s == 0 yet still spend real step time, and
    # forensics must tell "pool was slow" from "master was slow".
    master_s: float = 0.0
    # -- pool span telemetry (DESIGN.md §11): overlap measured, not asserted
    span_s: float = 0.0     # pool makespan of the step's runs (one group
    #                         timeline in overlap mode; == busy_s serial)
    busy_s: float = 0.0     # sum of per-run spans — the serial-equivalent
    #                         pool occupancy of the step
    serial_s: float = 0.0   # consumed pieces' raw (unpipelined) stage time
    overlap_s: float = 0.0  # ship/compute time hidden by streamed chunks:
    #                         serial_s - booked piece service time
    prefill_span_s: float = 0.0  # pool time attributed to prefill calls
    decode_span_s: float = 0.0   # pool time attributed to the decode call
    # -- membership telemetry (DESIGN.md §12): the fleet as the step saw it
    alive: int = 0    # alive workers after this step's churn + autoscaling
    joined: int = 0   # workers added this step (scripted churn + autoscaler)
    left: int = 0     # workers removed or drained this step
    # -- live scheme telemetry (DESIGN.md §13): the (n, k) the step's coded
    # GEMMs actually ran under, after any redundancy re-plan at its boundary
    coded_n: int = 0
    coded_k: int = 0
    # -- prefill-efficiency telemetry (DESIGN.md §14)
    packed_tokens: int = 0      # real prompt tokens prefilled via packing
    packed_pad_tokens: int = 0  # padding slots the pack wasted (masked out)
    prefill_chunks: int = 0     # chunk-resume calls issued this step
    prefix_hit_tokens: int = 0  # prompt positions restored from the cache
    cache_bytes: int = 0        # resident prefix-cache bytes after the step
    cache_evictions: int = 0    # prefix-cache blocks evicted this step
    # -- real-clock telemetry: measured on the host's clock (perf_counter),
    # always on; 0 on the virtual plane, whose records stay pure functions
    # of the seeds
    wait_s: float = 0.0     # host seconds blocked on the card in the step's
    #                         calls: the sampled tokens' copy to the host
    #                         (Engine.wait_s), and the mesh's waits for a
    #                         run's report (MeshExecutor.wait_s)
    sched_s: float = 0.0    # the step's wall, its start to its record, less
    #                         its model calls' walls: the scheduler's own
    #                         host work (admission, cache joins, retirement)
    prefill_calls: int = 0   # the engine's prefill calls in the step
    prefill_tokens: int = 0  # their prompt tokens


@dataclasses.dataclass
class ServeResult:
    """Everything a load test produces, metrics-ready."""

    records: list[RequestRecord]
    steps: list[StepRecord]
    completions: list[Completion]  # Engine-compatible view (latency from arrival)
    t_end: float
    # membership timeline: (t, action, worker) for every applied fleet
    # change — scripted churn and autoscaler decisions alike
    membership: list = dataclasses.field(default_factory=list)
    # redundancy re-plans applied by autoscale_redundancy: (t, n, k) at the
    # virtual instant the live scheme changed (step boundary, pool idle)
    replans: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Lane:
    req: Request
    rec: RequestRecord
    tokens: list


@dataclasses.dataclass
class _Stream:
    """A prompt mid-prefill: it owns a batch slot (so admission cannot
    oversubscribe the decode batch it will join) but decodes nothing until
    its last chunk lands.  ``pos`` counts consumed prompt tokens — prefix
    -cache hits start it at the restored length."""

    req: Request
    rec: RequestRecord
    cache: dict
    pos: int


class ServingScheduler:
    """Continuous batching in front of an :class:`Engine`.

    ``policy`` orders admission from the arrival queue: ``"fcfs"`` (arrival
    order) or ``"shortest_prompt"`` (SPT among arrived — lower mean wait,
    starvation-prone at overload; both are load-testable on purpose).

    ``max_seq`` sizes every lane's ring cache; all lanes must share it to
    concatenate into one batch, so it must cover the workload's longest
    ``prompt + max_new`` (``Workload.max_seq``).

    ``eos_id`` retires a lane the step its sampled token hits it (the EOS
    token itself is kept, vLLM-style); ``max_new`` always caps.

    ``master_call_s`` charges a fixed virtual cost per model call (the
    master's own encode/decode/GEMM work, which pool runs don't see);
    virtual mode otherwise only advances on pool-run completions.

    ``fault_drift`` re-scripts the pool's :class:`FaultPlan` per *step*
    (scenario: a worker starts straggling mid-load), and
    ``delay_seed_stride`` re-seeds a seedable pool delay model every step
    so round-trips stay stochastic across steps instead of replaying the
    identical (seed, worker, piece) draw forever.

    ``overlap`` (DESIGN.md §11) issues each step's independent model calls
    on ONE pool group timeline instead of a fresh idle pool per call: the
    carried-over batch's decode is dispatched first (its token is due this
    step), then each admission prefill, every call chained internally
    (``CodedExecutor.chain``) so its sequential GEMM runs stay causally
    ordered while the *calls* contend for the same workers.  The step then
    costs the group's makespan — max completion across calls — rather than
    the serial sum of per-call costs, and newly admitted lanes join the
    decode batch the NEXT step (their token values are unchanged; only
    timing attribution moves).  Ignored when the engine has no executor.

    ``packed`` (DESIGN.md §14) prefills a step's whole admission — mixed
    prompt lengths included — in ONE padded, masked engine call instead of
    one call per distinct length.  Token streams are bitwise-unchanged
    (causality hides right-padding; each lane's logits are gathered at its
    own last real position); what changes is the dispatch bill: one
    n-piece pool dispatch per GEMM per *admission*, never per length
    bucket.  Defaults to the engine's architecture capability.

    ``chunk_tokens`` > 0 turns prompts longer than the chunk into prefill
    *streams*: each scheduler step advances every stream by one chunk
    (``Engine.prefill_chunk``) alongside the running batch's decode, so a
    long prompt stops monopolizing the pool for a whole prefill and
    decode TPOT stays bounded by the chunk size.  A stream owns a batch
    slot from admission and joins the decode batch the step its last
    chunk lands (that chunk's sample is its first token).

    ``prefix_cache`` attaches a :class:`~repro.serving.prefix_cache.
    PrefixCache`: admission looks up ``prompt[:-1]``, restores every
    matched block's KV into the lane (``Engine.cache_from_prefix`` — no
    pool dispatch, charged zero virtual time: it is master-local slicing)
    and prefills only the unmatched suffix as a stream; completed
    prefills insert their prompt's blocks back.  Cached KV is post-decode
    plaintext, so ``retarget_coded``, churn, and autoscaling invalidate
    nothing.  Both features need the serial timeline (``overlap=False``).
    """

    def __init__(self, engine: Engine, *, max_seq: int, max_batch: int = 8,
                 policy: str = "fcfs", eos_id: int | None = None,
                 master_call_s: float = 0.0,
                 fault_drift: StragglerDrift | None = None,
                 delay_seed_stride: int = 0, overlap: bool = False,
                 churn: "ChurnSchedule | None" = None,
                 autoscaler=None, autoscale_redundancy: bool = False,
                 packed: bool | None = None, chunk_tokens: int = 0,
                 prefix_cache: PrefixCache | None = None,
                 trace=None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if max_batch < 1:
            raise ValueError(f"need max_batch >= 1, got {max_batch}")
        if max_seq < 2:
            raise ValueError(f"need max_seq >= 2, got {max_seq}")
        self.engine = engine
        self.max_seq = int(max_seq)
        self.max_batch = int(max_batch)
        self.policy = policy
        self.eos_id = eos_id
        self.master_call_s = float(master_call_s)
        self.fault_drift = fault_drift
        self.delay_seed_stride = int(delay_seed_stride)
        # elastic serving (DESIGN.md §12): ``churn`` scripts membership on
        # the serving timeline — events with t <= the step's start are
        # applied at the step boundary, while the pool is idle, so the
        # whole run stays a pure function of its seeds; ``autoscaler`` (a
        # dist.Autoscaler) additionally sizes the fleet from each step's
        # queue depth.  Both need the engine to run on a pool.
        self.churn = churn
        self.autoscaler = autoscaler
        # close the redundancy loop (DESIGN.md §13): when on, each step
        # boundary feeds Autoscaler.recommend_redundancy back into the LIVE
        # scheme's (n, k) via Engine.retarget_coded — opt-in, because it
        # changes the coded math mid-serve and pinned timelines must ask
        # for it
        self.autoscale_redundancy = bool(autoscale_redundancy)
        self.replans: list = []
        ex = engine.executor
        if ex is None and (churn is not None or autoscaler is not None):
            raise ValueError("churn/autoscaler need an executor-backed "
                             "engine (there is no fleet to change)")
        if self.autoscale_redundancy and autoscaler is None:
            raise ValueError("autoscale_redundancy=True needs autoscaler= "
                             "(recommend_redundancy is its method)")
        if self.autoscale_redundancy and not engine.cfg.coded_n:
            raise ValueError("autoscale_redundancy=True needs a coded "
                             "engine (there is no live (n, k) to re-plan)")
        self.overlap = bool(overlap) and ex is not None
        self._virtual = (ex is not None
                         and getattr(ex.pool.clock, "virtual", False))
        self._base_delay = ex.pool.delay_model if ex is not None else None
        # -- prefill efficiency (DESIGN.md §14).  packed=None means "pack
        # when the architecture allows it" — auto-off for archs where
        # padding leaks into the math (SSM state, MoE capacity, sliding
        # window), so the grouped-by-length path stays their default.
        if packed is None:
            packed = engine.supports_packed
        elif packed and not engine.supports_packed:
            raise ValueError(
                "packed=True needs a dense-attention engine (this "
                "architecture integrates padding into its state); pass "
                "packed=None to auto-select")
        self.packed = bool(packed)
        if chunk_tokens < 0:
            raise ValueError(f"need chunk_tokens >= 0, got {chunk_tokens}")
        if chunk_tokens or prefix_cache is not None:
            if not engine.supports_packed:
                raise ValueError(
                    "chunked prefill / prefix caching need a dense-"
                    "attention engine: chunk resume and KV restore assume "
                    "attention state is exactly the KV slots")
            if self.overlap:
                raise ValueError(
                    "chunk_tokens/prefix_cache schedule prefill streams "
                    "on the serial step timeline; overlap=True is not "
                    "supported with them")
        self.chunk_tokens = int(chunk_tokens)
        self.prefix_cache = prefix_cache
        # optional telemetry.TraceSink (DESIGN.md §15): during serve() it
        # is wired into the executor and pool, its ``origin`` is advanced
        # along the serving timeline so piece/run spans place globally,
        # and each step emits one "step" span — piece ⊂ run ⊂ step.
        self.trace = trace
        self._step_master_s = 0.0
        self._step_call_s = 0.0  # wall seconds of the step's model calls

    # -- internals ---------------------------------------------------------
    def _timed_call(self, fn: Callable, *args, at: float | None = None
                    ) -> tuple:
        """Run one model call; return (result, cost_s) on the scheduler's
        time plane.  Virtual cost = master_call_s + the (virtual)
        completion time of every pool run the call issued — a gather-all
        probe is honestly charged its LAST arrival, since that is what the
        master waited for.

        ``at`` is the call's start on the serving timeline: with a trace
        sink attached, the sink's ``origin`` is placed at ``at +
        master_call_s`` and advanced past each run's accepting arrival, so
        the call's (group-relative) piece/run spans land serially on the
        global timeline — exactly mirroring how the virtual cost accrues.
        Master-side time (wall when measured, ``master_call_s`` when
        virtual) accrues into the step's ``master_s``."""
        ex = self.engine.executor
        if ex is None:
            w0 = time.perf_counter()
            # every engine step copies its sampled tokens to the host
            # before it returns, and that copy waits for the step's device
            # work: the span below holds the call's work on the card
            out = fn(*args)
            wall = time.perf_counter() - w0
            self._step_master_s += wall
            self._step_call_s += wall
            return out, wall
        runs = []
        prev = ex.on_report
        sink = self.trace if self._virtual else None
        if sink is not None and at is not None:
            sink.origin = at + self.master_call_s

        def hook(r):
            runs.append(r)
            # spans for this run were emitted BEFORE on_report fired, so
            # advancing the origin here displaces only the runs after it
            if sink is not None and r.arrivals:
                sink.origin += max(a.t for a in r.arrivals)
            if prev is not None:
                prev(r)

        ex.on_report = hook
        try:
            w0 = time.perf_counter()
            out = fn(*args)
            wall = time.perf_counter() - w0
        finally:
            ex.on_report = prev
        self._step_call_s += wall
        if not self._virtual:
            self._step_master_s += max(
                wall - sum(r.wall_s for r in runs), 0.0)
            return out, wall
        self._step_master_s += self.master_call_s
        dt = self.master_call_s
        for r in runs:
            if r.arrivals:
                dt += max(a.t for a in r.arrivals)
        return out, dt

    def _arm_step(self, step: int) -> None:
        """Per-step pool scripting: fault drift + delay reseed."""
        ex = self.engine.executor
        if ex is None:
            return
        if self.fault_drift is not None:
            ex.pool.fault_plan = self.fault_drift.plan_at(step)
        dm = self._base_delay
        if (self.delay_seed_stride and dm is not None
                and dataclasses.is_dataclass(dm) and hasattr(dm, "seed")):
            ex.pool.delay_model = dataclasses.replace(
                dm, seed=dm.seed + step * self.delay_seed_stride)

    def _admit_order(self, ready: list) -> list:
        if self.policy == "shortest_prompt":
            return sorted(ready, key=lambda r: (len(r.prompt), r.arrival_s,
                                                r.rid))
        return ready  # fcfs: queue is already (arrival_s, rid)-sorted

    def _counters(self) -> tuple:
        ex = self.engine.executor
        if ex is None:
            return 0, 0
        return ex.pool.dispatch_count, ex.run_count

    def _real_counters(self) -> tuple:
        """(perf_counter, host seconds blocked on the card, prefill calls,
        prefill tokens) now: the engine's cumulative counters, plus the
        mesh's own waits (a pool keeps none)."""
        eng = self.engine
        return (time.perf_counter(),
                eng.wait_s + getattr(eng.executor, "wait_s", 0.0),
                eng.prefill_calls, eng.prefill_tokens)

    def _real_fields(self, start: tuple) -> dict:
        """The step's real-clock :class:`StepRecord` fields from
        ``_real_counters()`` read at its start; none on the virtual plane."""
        if self._virtual:
            return {}
        now = self._real_counters()
        return dict(
            wait_s=now[1] - start[1],
            sched_s=max(now[0] - start[0] - self._step_call_s, 0.0),
            prefill_calls=now[2] - start[2],
            prefill_tokens=now[3] - start[3])

    def _cache_counters(self) -> tuple:
        if self.prefix_cache is None:
            return 0, 0
        return (self.prefix_cache.stats.hit_tokens,
                self.prefix_cache.stats.evictions)

    # -- prefill streams (DESIGN.md §14) -----------------------------------
    def _open_stream(self, r: Request, t_start: float,
                     records: list) -> "_Stream | None":
        """Decide how ``r`` prefills.  Returns a :class:`_Stream` when the
        prompt resumes from a prefix-cache hit or is long enough to chunk;
        None sends it down the cold packed path.  Lookup and KV restore
        are master-local slicing — they advance no clock and dispatch
        nothing (the whole point: skipped work, not protected work)."""
        if self.prefix_cache is None and not self.chunk_tokens:
            return None
        hit, segs = 0, []
        if self.prefix_cache is not None:
            # prompt[:-1]: the last position is ALWAYS computed — its
            # logits mint the first generated token (the vLLM rule)
            hit, segs = self.prefix_cache.lookup(r.prompt[:-1])
        if hit == 0 and not (self.chunk_tokens
                             and len(r.prompt) > self.chunk_tokens):
            return None
        rec = RequestRecord(r.rid, len(r.prompt), r.max_new, r.arrival_s,
                            admit_s=t_start)
        records.append(rec)
        cache = (self.engine.cache_from_prefix(segs, hit, self.max_seq)
                 if hit else self.engine.new_stream_cache(self.max_seq))
        return _Stream(req=r, rec=rec, cache=cache, pos=hit)

    def _advance_streams(self, streams, lanes, new_caches, retired, t,
                         completions) -> tuple:
        """One chunk for every live stream.  A stream whose last chunk
        lands gets its first token from that chunk's sample, inserts its
        prompt's KV into the prefix cache, and joins the decode batch
        (same step, like any cold admission)."""
        still = []
        n_chunks = 0
        for s in streams:
            rest = len(s.req.prompt) - s.pos
            take = min(self.chunk_tokens, rest) if self.chunk_tokens else rest
            chunk = np.asarray(s.req.prompt[s.pos:s.pos + take],
                               np.int32)[None]
            (tok, s.cache), dt = self._timed_call(
                self.engine.prefill_chunk, s.cache, chunk, at=t)
            t += dt
            n_chunks += 1
            s.pos += take
            if s.pos < len(s.req.prompt):
                still.append(s)
                continue
            self._insert_prefix(s.req.prompt, s.cache, 0)
            s.rec.first_token_s = t
            lane = _Lane(s.req, s.rec, [int(tok[0])])
            if self._finished(lane):
                self._retire(lane, t, completions)
                retired += 1
            else:
                lanes.append(lane)
                # cache_cat normalizes the stream's scalar pos to the (B,)
                # lane vector the decode batch carries
                new_caches.append(cache_cat([s.cache]))
        return still, n_chunks, retired, t

    def _insert_prefix(self, prompt, cache: dict, lane: int) -> None:
        """Offer a finished prefill's KV to the prefix cache (whole blocks
        only; already-cached blocks cost an LRU touch, not a copy)."""
        if self.prefix_cache is None:
            return
        self.prefix_cache.insert(
            prompt, lambda t0, t1: self.engine.kv_prefix(cache, lane, t0, t1))

    # -- the loop ----------------------------------------------------------
    def serve(self, requests: Sequence[Request]) -> ServeResult:
        seen = set()
        for r in requests:
            if r.rid in seen:
                raise ValueError(f"duplicate rid {r.rid}: records and "
                                 "completions are keyed by rid")
            seen.add(r.rid)
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: need max_new >= 1 "
                                 "(prefill-only requests have no tokens to "
                                 "continuously batch)")
            if len(r.prompt) + r.max_new > self.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + max_new "
                    f"{r.max_new} exceeds max_seq={self.max_seq}")
        self.replans = []
        ex = self.engine.executor
        if ex is not None:
            # _arm_step mutates the pool's fault/delay scripting per step;
            # restore it afterwards so a reused pool's next run (another
            # arm of a comparison, say) does not inherit this run's last
            # drift phase or reseeded delay model
            prev_pool_state = (ex.pool.fault_plan, ex.pool.delay_model)
        try:
            return self._serve(requests)
        finally:
            if ex is not None:
                ex.pool.fault_plan, ex.pool.delay_model = prev_pool_state

    def _serve(self, requests: Sequence[Request]) -> ServeResult:
        queue = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        lanes: list[_Lane] = []
        cache = None
        t = 0.0
        step = 0
        records: list[RequestRecord] = []
        steps: list[StepRecord] = []
        completions: list[Completion] = []
        ex = self.engine.executor
        # step-scoped report collector for the StepRecord span telemetry;
        # _timed_call's temporary hook chains to it, so both modes feed it
        step_reports: list = []
        outer = ex.on_report if ex is not None else None
        # wire the trace sink into the execution layers for the duration
        # of this serve (save/restore: the executor may be shared across
        # comparison arms).  The pool guard covers the mesh backend, whose
        # fleet shim has no piece timeline to trace.
        sink_prev: list = []
        if ex is not None and self.trace is not None:
            for obj in (ex, ex.pool):
                if hasattr(obj, "trace_sink"):
                    sink_prev.append((obj, obj.trace_sink))
                    obj.trace_sink = self.trace
        if ex is not None:
            ex.on_report = (lambda r: (step_reports.append(r),
                                       outer(r) if outer is not None
                                       else None))
        try:
            return self._serve_loop(queue, lanes, cache, t, step, records,
                                    steps, completions, step_reports)
        finally:
            if ex is not None:
                ex.on_report = outer
            for obj, prev in sink_prev:
                obj.trace_sink = prev

    def _serve_loop(self, queue, lanes, cache, t, step, records, steps,
                    completions, step_reports) -> ServeResult:
        membership: list = []
        churn_idx = 0
        streams: list[_Stream] = []
        ex = self.engine.executor
        with self.engine.executor_ctx():
            while queue or lanes or streams:
                with span("serve.step"):
                    real0 = self._real_counters()
                    if (not lanes and not streams and queue
                            and queue[0].arrival_s > t):
                        # idle system: jump to next arrival
                        t = queue[0].arrival_s
                    t_start = t
                    self._arm_step(step)
                    step_reports.clear()
                    self._step_master_s = 0.0
                    self._step_call_s = 0.0
                    d0, r0 = self._counters()
                    hit0, ev0 = self._cache_counters()
                    # -- admission: arrived requests fill the free lanes --
                    with span("serve.admit"):
                        n_ready = 0
                        while (n_ready < len(queue)
                               and queue[n_ready].arrival_s <= t):
                            n_ready += 1
                        room = self.max_batch - len(lanes) - len(streams)
                        admit = self._admit_order(
                            queue[:n_ready])[:max(room, 0)]
                        # remove by identity: dataclass equality would
                        # compare the ndarray prompt fields and raise on
                        # ambiguous truth value
                        queue = [q for q in queue
                                 if not any(q is r for r in admit)]
                        qdepth = n_ready - len(admit)
                    # -- elastic membership: scripted churn, then autoscaling,
                    #    applied at the step boundary while the pool is idle
                    churn_idx, joined, left = self._apply_membership(
                        churn_idx, t_start, qdepth, membership)
                    packed_tok = packed_pad = n_chunks = 0
                    if self.overlap and (admit or lanes):
                        (lanes, cache, retired, n_decoded, pf_d, pf_r,
                         i_pf, i_dec, t) = self._overlap_step(
                            lanes, cache, admit, t_start, records,
                            completions, step_reports)
                    else:
                        # -- classify the admission: prefix-cache hits and
                        #    long prompts become chunk streams; the rest
                        #    prefill cold this step (packed: ONE call)
                        new_caches = []
                        retired = 0
                        cold = []
                        with span("serve.admit"):
                            for r in admit:
                                s = self._open_stream(r, t_start, records)
                                (cold.append(r) if s is None
                                 else streams.append(s))
                        # -- join-at-prefill for the cold admission -------
                        groups = ([cold] if self.packed and cold
                                  else _length_groups(cold))
                        for group in groups:
                            if self.packed:
                                (first, gcache), dt = self._timed_call(
                                    self.engine.prefill_packed,
                                    [r.prompt for r in group], self.max_seq,
                                    at=t)
                                tmax = max(len(r.prompt) for r in group)
                                real = sum(len(r.prompt) for r in group)
                                packed_tok += real
                                packed_pad += len(group) * tmax - real
                            else:
                                prompts = np.stack([r.prompt for r in group])
                                (first, gcache), dt = self._timed_call(
                                    self.engine.prefill_batch, prompts,
                                    self.max_seq, at=t)
                            t += dt
                            glanes = []
                            with span("serve.admit"):
                                for j, r in enumerate(group):
                                    self._insert_prefix(r.prompt, gcache, j)
                                    rec = RequestRecord(
                                        r.rid, len(r.prompt), r.max_new,
                                        r.arrival_s, admit_s=t_start,
                                        first_token_s=t)
                                    lane = _Lane(r, rec, [int(first[j])])
                                    records.append(rec)
                                    glanes.append(lane)
                            with span("serve.retire"):
                                done = [j for j, ln in enumerate(glanes)
                                        if self._finished(ln)]
                                for j in done:
                                    self._retire(glanes[j], t, completions)
                                    retired += 1
                            keep = [j for j in range(len(glanes))
                                    if j not in done]
                            if keep:
                                lanes.extend(glanes[j] for j in keep)
                                with span("serve.join"):
                                    new_caches.append(
                                        gcache if len(keep) == len(glanes)
                                        else cache_take(gcache, keep))
                        # -- advance every prefill stream by one chunk ----
                        if streams:
                            (streams, n_chunks, retired,
                             t) = self._advance_streams(
                                streams, lanes, new_caches, retired, t,
                                completions)
                        d_pf, r_pf = self._counters()
                        pf_d, pf_r = d_pf - d0, r_pf - r0
                        i_pf = (0, len(step_reports))
                        # -- one decode step for the whole running batch ---
                        n_decoded = len(lanes)
                        if lanes:
                            parts = (([cache] if cache is not None else [])
                                     + new_caches)
                            with span("serve.join"):
                                cache = cache_cat(parts)
                            last = np.asarray(
                                [ln.tokens[-1] for ln in lanes], np.int32)
                            (nxt, cache), dt = self._timed_call(
                                self.engine.decode_batch, cache, last, at=t)
                            t += dt
                            with span("serve.retire"):
                                for j, ln in enumerate(lanes):
                                    ln.tokens.append(int(nxt[j]))
                                done = [j for j, ln in enumerate(lanes)
                                        if self._finished(ln)]
                                for j in done:
                                    self._retire(lanes[j], t, completions)
                                    retired += 1
                            if done:
                                keep = [j for j in range(len(lanes))
                                        if j not in done]
                                lanes = [lanes[j] for j in keep]
                                with span("serve.join"):
                                    cache = (cache_take(cache, keep) if keep
                                             else None)
                        else:
                            cache = None
                        i_dec = (i_pf[1], len(step_reports))
                    d1, r1 = self._counters()
                    span_s, busy_s, serial_s, overlap_s = self._pool_spans(
                        step_reports, grouped=self.overlap)
                    steps.append(StepRecord(
                        step, t_start, t, batch=n_decoded,
                        admitted=len(admit), retired=retired,
                        queue_depth=qdepth,
                        dispatches=d1 - d0, runs=r1 - r0,
                        prefill_dispatches=pf_d, prefill_runs=pf_r,
                        master_s=self._step_master_s,
                        span_s=span_s, busy_s=busy_s, serial_s=serial_s,
                        overlap_s=overlap_s,
                        prefill_span_s=self._pool_spans(
                            step_reports[i_pf[0]:i_pf[1]],
                            grouped=self.overlap)[0],
                        decode_span_s=self._pool_spans(
                            step_reports[i_dec[0]:i_dec[1]],
                            grouped=self.overlap)[0],
                        alive=(len(ex.pool.alive_workers())
                               if ex is not None else 0),
                        joined=joined, left=left,
                        coded_n=self.engine.cfg.coded_n,
                        coded_k=self.engine.cfg.coded_k,
                        packed_tokens=packed_tok,
                        packed_pad_tokens=packed_pad,
                        prefill_chunks=n_chunks,
                        prefix_hit_tokens=self._cache_counters()[0] - hit0,
                        cache_bytes=(self.prefix_cache.bytes
                                     if self.prefix_cache is not None else 0),
                        cache_evictions=self._cache_counters()[1] - ev0,
                        **self._real_fields(real0)))
                    if self.trace is not None:
                        from ..telemetry.trace import Span
                        self.trace.span(Span(
                            "step", "serve", t_start, max(t - t_start, 0.0),
                            "scheduler",
                            {"step": step, "batch": n_decoded,
                             "admitted": len(admit), "retired": retired,
                             "dispatches": d1 - d0, "runs": r1 - r0,
                             "master_s": self._step_master_s}))
                step += 1
        completions.sort(key=lambda c: c.rid)
        records.sort(key=lambda r: r.rid)
        return ServeResult(records=records, steps=steps,
                           completions=completions, t_end=t,
                           membership=membership, replans=list(self.replans))

    def _apply_membership(self, idx: int, t: float, qdepth: int,
                          membership: list) -> tuple:
        """Apply every scripted churn event due by ``t``, then let the
        autoscaler react to the queue depth.  Returns (next churn index,
        workers joined, workers removed/drained) for the StepRecord.
        Stale events (a worker the autoscaler already drained, say) are
        skipped — the timeline records what actually happened."""
        ex = self.engine.executor
        joined = left = 0
        if self.churn is not None:
            evs = self.churn.events
            while idx < len(evs) and evs[idx].t <= t:
                e = evs[idx]
                idx += 1
                try:
                    if e.action == "join":
                        w = ex.pool.add_worker()
                        joined += 1
                    elif e.action == "remove":
                        ex.pool.remove_worker(e.worker)
                        w, left = e.worker, left + 1
                    else:
                        ex.pool.drain(e.worker)
                        w, left = e.worker, left + 1
                except (KeyError, ValueError):
                    continue
                membership.append((t, e.action, w))
        if self.autoscaler is not None:
            dec = self.autoscaler.step(qdepth, t)
            for w in dec.joined:
                membership.append((t, "join", w))
            for w in dec.drained:
                membership.append((t, "drain", w))
            joined += len(dec.joined)
            left += len(dec.drained)
            if self.autoscale_redundancy:
                self._replan_redundancy(t)
        return idx, joined, left

    def _replan_redundancy(self, t: float) -> None:
        """Feed ``Autoscaler.recommend_redundancy`` back into the live
        scheme (DESIGN.md §13): n follows the fleet, and for free-k codes
        (mds/lt) k = n - r where r counts fitted stragglers + churn
        headroom; structural-k schemes (replication, uncoded) re-derive
        their own k from n.  Applied at the step boundary while the pool
        is idle — the re-plan instant lands on the virtual clock as the
        step's ``t_start`` — and recorded in ``self.replans``."""
        from ..models.model import _coded_scheme

        eng = self.engine
        ex = eng.executor
        scaler = self.autoscaler
        alive = sorted(ex.pool.alive_workers())
        if not alive:
            return
        n_new = len(alive)
        if scaler.speeds_fn is not None:
            sp = list(scaler.speeds_fn(max(alive) + 1))
            speeds = [sp[w] for w in alive]
        else:
            speeds = [1.0] * n_new
        r = scaler.recommend_redundancy(speeds)
        cur = _coded_scheme(eng.cfg.coded_scheme, eng.cfg.coded_n,
                            eng.cfg.coded_k or None)
        from ..core.schemes import commutes_elementwise

        if commutes_elementwise(cur):
            # selection schemes carry structural k (replication floor(n/2),
            # uncoded n) — only n follows the recommendation
            k_new = None
        else:
            k_new = max(1, min(n_new - r, n_new))
        cand = _coded_scheme(eng.cfg.coded_scheme, n_new, k_new)
        if (cand.n, cand.k) == (cur.n, cur.k):
            return
        eng.retarget_coded(cand.n, cand.k)
        self.replans.append((t, cand.n, cand.k))

    def _overlap_step(self, lanes, cache, admit, t_start, records,
                      completions, step_reports):
        """One serving step with its model calls issued on ONE pool group
        timeline (DESIGN.md §11).

        The carried-over batch's decode is dispatched first — its token is
        due this step — then each admission prefill; every call runs inside
        ``CodedExecutor.chain`` so its own sequential GEMM runs stay
        causally ordered, while the calls' pieces contend FIFO on the same
        workers (queueing shows up as late ``t_dispatch``, never inflated
        ``t_compute``).  Newly admitted lanes join the decode batch the
        NEXT step, so decode and prefill are genuinely independent within
        the step; token values are unchanged vs. serial mode.  The step
        costs the group's makespan plus one ``master_call_s`` per call;
        each lane's first token lands when ITS prefill chain drains, and
        the decode token when the decode chain drains.
        """
        ex = self.engine.executor
        n_calls = 0
        dec_out = None
        pf_out = []
        i_dec = (0, 0)
        if self.trace is not None and self._virtual:
            # one shared group timeline: runs carry group-relative
            # t_submit/t_complete that already encode their ordering, so
            # the origin pins once at the step start and never advances
            self.trace.origin = t_start
        w0 = time.perf_counter()
        with ex.pool.group():
            if lanes:
                last = np.asarray([ln.tokens[-1] for ln in lanes], np.int32)
                with ex.chain():
                    dec_out = self.engine.decode_batch(cache, last)
                n_calls += 1
                i_dec = (0, len(step_reports))
            d_mid, r_mid = self._counters()
            i_pf0 = len(step_reports)
            groups = ([admit] if self.packed and admit
                      else _length_groups(admit))
            for group in groups:
                j0 = len(step_reports)
                with ex.chain():
                    if self.packed:
                        first, gcache = self.engine.prefill_packed(
                            [r.prompt for r in group], self.max_seq)
                    else:
                        prompts = np.stack([r.prompt for r in group])
                        first, gcache = self.engine.prefill_batch(
                            prompts, self.max_seq)
                n_calls += 1
                end = max((r.t_complete for r in step_reports[j0:]),
                          default=0.0)
                pf_out.append((group, first, gcache, n_calls, end))
            i_pf = (i_pf0, len(step_reports))
        wall = time.perf_counter() - w0
        self._step_call_s += wall
        d_end, r_end = self._counters()
        pf_d, pf_r = d_end - d_mid, r_end - r_mid
        if self._virtual:
            t_done = max((r.t_complete for r in step_reports), default=0.0)
            t_end = t_start + n_calls * self.master_call_s + t_done
            self._step_master_s += n_calls * self.master_call_s
        else:
            t_end = t_start + wall
            self._step_master_s += max(
                wall - sum(r.wall_s for r in step_reports), 0.0)
        # -- decode results: the token lands when the decode chain drains
        n_decoded = len(lanes)
        retired = 0
        if dec_out is not None:
            nxt, cache = dec_out
            if self._virtual:
                dec_end = max((r.t_complete
                               for r in step_reports[i_dec[0]:i_dec[1]]),
                              default=0.0)
                t_dec = t_start + self.master_call_s + dec_end
            else:
                t_dec = t_end
            for j, ln in enumerate(lanes):
                ln.tokens.append(int(nxt[j]))
            done = [j for j, ln in enumerate(lanes) if self._finished(ln)]
            for j in done:
                self._retire(lanes[j], t_dec, completions)
                retired += 1
            if done:
                keep = [j for j in range(len(lanes)) if j not in done]
                lanes = [lanes[j] for j in keep]
                cache = cache_take(cache, keep) if keep else None
        else:
            cache = None
        # -- prefill results: each group's first token lands when ITS
        #    chain drains (after the master slots of the calls before it)
        new_caches = []
        for (group, first, gcache, k_call, end) in pf_out:
            ft = (t_start + k_call * self.master_call_s + end
                  if self._virtual else t_end)
            glanes = []
            for j, r in enumerate(group):
                rec = RequestRecord(r.rid, len(r.prompt), r.max_new,
                                    r.arrival_s, admit_s=t_start,
                                    first_token_s=ft)
                lane = _Lane(r, rec, [int(first[j])])
                records.append(rec)
                glanes.append(lane)
            done = [j for j, ln in enumerate(glanes) if self._finished(ln)]
            for j in done:
                self._retire(glanes[j], ft, completions)
                retired += 1
            keep = [j for j in range(len(glanes)) if j not in done]
            if keep:
                lanes.extend(glanes[j] for j in keep)
                new_caches.append(gcache if len(keep) == len(glanes)
                                  else cache_take(gcache, keep))
        if new_caches:
            cache = cache_cat(([cache] if cache is not None else [])
                              + new_caches)
        return (lanes, cache, retired, n_decoded, pf_d, pf_r, i_pf, i_dec,
                t_end)

    @staticmethod
    def _pool_spans(reports, *, grouped: bool) -> tuple:
        """(span, busy, serial, overlap) pool seconds of a step's reports.

        ``busy`` sums per-run spans (the serial-equivalent pool occupancy);
        ``span`` is the makespan on the shared group timeline when
        ``grouped`` (== busy for serial mode, where every run gets a fresh
        timeline and spans just add); ``serial`` sums the consumed pieces'
        raw stage durations and ``overlap`` their gap to the booked
        (pipelined) service time — the ship/compute time hidden by
        streamed chunks.
        """
        busy = serial = hidden = 0.0
        for r in reports:
            busy += max(r.t_complete - r.t_submit, 0.0)
            for tm in r.timings:
                raw = sum(tm.stages) if tm.stages else tm.t_compute
                serial += raw
                hidden += max(raw - tm.t_compute, 0.0)
        if not reports:
            return 0.0, 0.0, 0.0, 0.0
        if grouped:
            span = max(0.0, max(r.t_complete for r in reports)
                       - min(r.t_submit for r in reports))
        else:
            span = busy
        return span, busy, serial, hidden

    def _finished(self, lane: _Lane) -> bool:
        if len(lane.tokens) >= lane.req.max_new:
            return True
        return self.eos_id is not None and lane.tokens[-1] == self.eos_id

    @staticmethod
    def _retire(lane: _Lane, t: float, completions: list) -> None:
        lane.rec.done_s = t
        lane.rec.n_tokens = len(lane.tokens)
        completions.append(Completion(
            lane.req.rid, np.asarray(lane.tokens, np.int32),
            latency_s=t - lane.req.arrival_s,
            first_token_s=lane.rec.first_token_s - lane.req.arrival_s))


def _length_groups(admitted: Sequence[Request]) -> list:
    """Partition admitted requests into equal-prompt-length groups (the
    functional prefill has no padding mask), preserving admission order
    within each group."""
    groups: dict[int, list] = {}
    for r in admitted:
        groups.setdefault(len(r.prompt), []).append(r)
    return list(groups.values())
