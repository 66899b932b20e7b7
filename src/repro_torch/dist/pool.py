"""In-process distributed worker pool with k-of-n early exit (DESIGN.md §7).

``WorkerPool`` runs W persistent daemon threads ("workers").  A run
dispatches N piece callables (real CUDA/torch compute) across the workers
and blocks in the master loop until a caller-supplied completion rule
(``until``) accepts the set of arrivals — for coded execution that is
"the arrived pieces form a decodable subset" (executor.py), at which point
the master *cancels* every straggler and returns.  Workers that the
:class:`~repro_torch.dist.faults.FaultPlan` kills post a failure event at their
would-be completion time and the master re-dispatches their unfinished
pieces to live workers.

Two time planes (see clock.py):

* ``RealClock`` — workers sleep out their modeled duration, arrivals reach
  the master in wall order, cancellation interrupts sleeping stragglers:
  the k-of-n saving is measured wall-clock.
* ``FakeClock`` — workers never sleep; every event carries a virtual
  timestamp computed from the DelayModel, and the master merges events in
  virtual-time order (a safe streaming merge: an event is processed only
  once no still-pending worker can emit an earlier one).  Runs are
  bit-deterministic regardless of OS scheduling.

Failure events ride the same time-ordered merge as arrivals, and every
master decision (decode-at-k, re-dispatch targets) is computed from
*processed* state only — never from the racy order in which events happen
to reach the queue — so FakeClock runs are bit-deterministic even when a
failure forces re-dispatch across several live workers.  Re-dispatched
pieces carry ``not_before = t_detect``, so completion times remain
causally consistent.

Concurrent runs (DESIGN.md §11): ``run_async`` submits a run and returns a
:class:`RunHandle` immediately; several in-flight runs interleave on the
same workers.  Runs submitted inside one ``pool.group()`` share a single
virtual timeline (per-worker ``t_free`` persists across them), which is
how the serving scheduler models a step's prefill and decode dispatches
*contending* for the same devices instead of pretending each run gets an
idle pool.  Outside a group every run starts a fresh timeline, so
``run()`` — which is just ``run_async(...).result()`` — behaves exactly
as the historical serial API.  In virtual mode a worker processes every
piece queued to it even after its run is cancelled: whether a cancel
lands before a dequeue is a wall-clock race, and skipping would fork the
shared group timeline on it.  Real-clock runs keep the skip (a cancelled
run's undispatched pieces are dropped) because there wall order *is* the
semantics.

Elastic membership (DESIGN.md §12): the fleet is never static.
``add_worker`` commissions a fresh worker (ids only grow — a departed id
is never reused), ``drain`` stops new dispatches while everything already
queued completes, and ``remove_worker`` is a permanent departure whose
in-flight pieces fail through the existing re-dispatch path.  On a
virtual clock, mid-run departures must be *scripted* (``at=`` — a
group-relative virtual time): the worker itself posts the failure at the
departure instant, which keeps the time-ordered merge deterministic
(there is no deterministic "now" inside a virtual run for an unscripted
removal to bind to).  A run whose obtainable piece set can never satisfy
its completion rule raises the typed :class:`Undecodable` instead of
hanging or spinning the re-dispatch loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import queue
import threading
import time
from typing import Any, Callable, Sequence

import torch

from ..telemetry.trace import span
from .clock import Clock, FakeClock, RealClock
from .faults import DelayModel, FaultPlan

__all__ = ["Piece", "Arrival", "PieceTiming", "RunReport", "RunHandle",
           "Undecodable", "WorkerPool"]

_STOP = object()
_MIN_DUR = 1e-9  # keeps per-worker virtual timelines strictly increasing


def _wait_for_device(result: Any) -> None:
    """Block until the device has finished the work behind ``result``.

    CUDA launches are asynchronous: ``piece.fn()`` returns once its kernels
    are queued.  A piece has only *arrived* when its values exist, so the
    worker synchronises the stream the piece ran on (this thread's current
    stream on the result's device) before it takes the elapsed time and
    posts the arrival.  This is the wait of a run submitted before the
    process touched CUDA; otherwise :func:`_run_piece` synchronises the
    worker's own stream, which holds this piece's kernels and no other
    worker's.
    """
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.current_stream(result.device).synchronize()


def _cuda_handoff() -> tuple | None:
    """``(master stream, event)`` for a run submitted from this thread, or
    None when the process has not touched CUDA (then no piece input can
    live on a card).  The event is recorded on the master's current stream
    after everything the master queued for the run (encode, slicing), so a
    worker that waits on it sees the pieces' inputs and nothing later."""
    if not torch.cuda.is_initialized():
        return None
    master = torch.cuda.current_stream()
    ready = torch.cuda.Event()
    ready.record(master)
    return master, ready


def _run_piece(fn: Callable[[], Any], handoff: tuple | None,
               stream: "torch.cuda.Stream | None"):
    """Run one piece on the worker's own CUDA stream and wait for it.

    Returns ``(result, stream)``; the worker keeps the stream (made at its
    first CUDA piece) for the pool's lifetime, so its caching-allocator
    pool stays warm from run to run.  The stream first waits for the
    master's ``ready`` event (the inputs exist), the piece launches on it,
    and the worker synchronises that stream alone — never the device, never
    another worker's stream.  A CUDA result is marked as used on the
    master's stream (``record_stream``), which consumes it, so its memory
    is not handed back to this worker's stream before the master's reads
    are done.  Without CUDA the piece runs as it is.  (Inputs are the
    master's: a real-clock straggler still computing when the master has
    decoded and freed them may read reused memory — its result is dropped
    unread.)
    """
    if handoff is None:
        result = fn()
        _wait_for_device(result)
        return result, stream
    master, ready = handoff
    if stream is None or stream.device != master.device:
        stream = torch.cuda.Stream(device=master.device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        result = fn()
        stream.synchronize()
    if isinstance(result, torch.Tensor) and result.is_cuda:
        result.record_stream(master)
    return result, stream


class Undecodable(RuntimeError):
    """The run's completion rule can never be satisfied from the pieces
    still obtainable (too many workers dead, removed, or draining) — the
    typed alternative to hanging on events that will never come or
    re-dispatching forever."""


@dataclasses.dataclass(frozen=True)
class Piece:
    """One dispatched subtask: coded piece index + its compute thunk."""

    idx: int
    fn: Callable[[], Any]
    not_before: float = 0.0  # virtual gate: re-dispatches start >= t_detect


@dataclasses.dataclass(frozen=True)
class Arrival:
    worker: int
    piece: int
    t: float  # virtual seconds from run start (== modeled wall in real mode)


@dataclasses.dataclass(frozen=True)
class PieceTiming:
    """Phase telemetry of one completed piece — the estimator's raw feed.

    ``t_dispatch`` is the virtual time the worker began serving the piece
    (after its queue wait and any ``not_before`` gate), ``t_compute`` the
    modeled service duration (the full rec+cmp+sen round-trip in delay-model
    mode, the measured compute time in measured mode), and
    ``t_arrival = t_dispatch + t_compute`` its completion at the master.
    Queueing behind other runs in a group widens ``t_dispatch`` only —
    ``t_compute`` is pure service time, never contention.
    """

    worker: int
    piece: int
    t_dispatch: float
    t_compute: float
    t_arrival: float
    # per-layer stage durations of a multi-layer (segment) piece, when the
    # delay model exposes them (faults.SegmentDelay) — raw *serial* stage
    # durations, so with streamed chunking (delay.chunks > 1) they sum to
    # MORE than the pipelined t_compute; the gap is the overlapped
    # ship/compute time.  Empty for measured mode.
    stages: tuple = ()


@dataclasses.dataclass
class RunReport:
    """What one pool run did — the executor's evidence trail."""

    t_complete: float                 # modeled time of the accepting arrival
    wall_s: float                     # measured wall-clock of the run
    subset: list[int]                 # piece ids the completion rule consumed
    arrivals: list[Arrival]           # arrivals processed, in (virtual) order
    failures: list[tuple[int, float]]  # (worker, t_detect)
    redispatched: list[tuple[int, int, int]]  # (piece, from_w, to_w)
    cancelled: list[int]              # piece ids dispatched but never consumed
    assignment: dict[int, int]        # piece id -> worker that produced it
    timings: list[PieceTiming] = dataclasses.field(default_factory=list)
    # virtual time the run was gated to start at (chained runs inherit the
    # previous run's t_complete) — t_complete - t_submit is the run's span
    t_submit: float = 0.0


@dataclasses.dataclass
class _RunCtx:
    """Per-run shared state handed to worker threads with each piece."""

    epoch: int
    group: int
    cancel: threading.Event
    faults: FaultPlan
    delay: DelayModel | None
    clock: Clock
    time_scale: float
    t0_wall: float   # wall origin of the run's GROUP (shared across a group)
    start_at: float  # virtual gate: no piece of this run starts earlier
    post: Callable[["_Event"], None]
    # (master stream, ready event) from _cuda_handoff(), None without CUDA
    handoff: tuple | None = None


@dataclasses.dataclass
class _Event:
    kind: str        # "arrival" | "failure" | "error"
    epoch: int
    worker: int
    piece: int
    t: float
    payload: Any = None
    t_start: float = 0.0  # virtual time the worker began serving the piece
    stages: tuple = ()    # per-layer durations (segment pieces)


@dataclasses.dataclass
class _MasterState:
    """One run's master bookkeeping (see the comment at its construction:
    receipt-time fields feed the safe-merge bound, processing-time fields
    feed every decision)."""

    owner: dict[int, int]
    thunks: dict[int, Callable[[], Any]]
    # -- receipt-time (racy; bound/liveness only) --
    pending: list[set[int]]
    last_t: list[float]
    arrived: set[int] = dataclasses.field(default_factory=set)
    heap: list = dataclasses.field(default_factory=list)
    # -- processing-time (deterministic under the time-ordered merge) --
    proc_t: list[float] = dataclasses.field(default_factory=list)
    dead: set[int] = dataclasses.field(default_factory=set)
    lost: dict[int, float] = dataclasses.field(default_factory=dict)
    results: dict[int, Any] = dataclasses.field(default_factory=dict)
    order: list[int] = dataclasses.field(default_factory=list)
    # re-dispatch rounds so far; bounded (each round kills >= 1 worker or
    # re-places every lost piece, so exceeding the worker count means the
    # obtainable set can never decode)
    redispatch_rounds: int = 0

    def outstanding(self, v: int) -> int:
        """Pieces assigned to v not yet *processed* as arrivals — the
        deterministic load measure for re-dispatch target choice."""
        done = set(self.order)
        return sum(1 for p, w in self.owner.items()
                   if w == v and p not in done and p not in self.lost)


class RunHandle:
    """One in-flight pool run.

    The pieces were already dispatched to the workers when the handle was
    created; :meth:`result` runs the master loop (collect arrivals in safe
    virtual order, re-dispatch after failures, cancel stragglers at
    acceptance) to completion and returns ``(results, report)``.  Every
    handle must eventually be resolved — an abandoned handle keeps its
    run's slot in the pool's active count open, pinning the group.
    Repeat calls return the cached outcome.
    """

    def __init__(self, pool: "WorkerPool", ctx: _RunCtx, st: _MasterState,
                 until, viable, report: RunReport, n: int, wall0: float,
                 events: "queue.Queue[_Event]"):
        self._pool = pool
        self._ctx = ctx
        self._st = st
        self._until = until
        self._viable = viable
        self._report = report
        self._n = n
        self._wall0 = wall0
        self._events = events
        self._outcome: Any = None
        self._resolved = False

    @property
    def report(self) -> RunReport:
        """The run's report (complete only after :meth:`result`)."""
        return self._report

    def cancel(self) -> None:
        """Abort the run's stragglers (real-clock early exit)."""
        self._ctx.cancel.set()

    def result(self) -> tuple[dict[int, Any], RunReport]:
        if self._resolved:
            if isinstance(self._outcome, BaseException):
                raise self._outcome
            return self._outcome
        try:
            self._outcome = self._pool._collect(self)
        except BaseException as e:
            self._outcome = e
            raise
        finally:
            self._resolved = True
        return self._outcome


class WorkerPool:
    """W threaded workers + a master that collects, re-dispatches, cancels.

    The pool is reusable across many runs — the serving engine keeps one
    per process — and runs may overlap: ``run_async`` dispatches
    immediately and returns a :class:`RunHandle`, so two executors sharing
    a pool no longer serialize behind a whole-run lock (and queueing behind
    another run shows up as late ``t_dispatch``, never as inflated
    ``t_compute``).  Each run posts events to its own queue, so a straggler
    still sleeping from run e cannot pollute run e+1.
    """

    def __init__(self, n_workers: int, *, clock: Clock | None = None,
                 delay_model: DelayModel | None = None,
                 fault_plan: FaultPlan | None = None,
                 time_scale: float = 1.0, timeout_s: float = 120.0):
        if n_workers < 1:
            raise ValueError(f"need n_workers >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.clock: Clock = clock if clock is not None else RealClock()
        self.delay_model = delay_model
        self.fault_plan = fault_plan or FaultPlan()
        self.time_scale = float(time_scale)
        self.timeout_s = float(timeout_s)
        # cumulative pieces handed to worker inboxes (initial dispatch +
        # re-dispatch after failures), across every run of this pool.  The
        # serving scheduler snapshots deltas of this to PROVE the batched-
        # dispatch claim on real runs: B co-scheduled requests share one
        # n-piece dispatch, so a step costs n pieces, not B*n.
        self.dispatch_count = 0
        # optional telemetry.TraceSink: when set, every resolved run emits
        # one "piece" span per PieceTiming (plus per-stage "phase" spans
        # when the stages sum fits inside the round trip — pipelined
        # chunked stages overlap and have no serial placement).  Unset
        # costs a single attribute load per run.
        self.trace_sink = None
        # submission bookkeeping: _group numbers shared virtual timelines
        # (workers reset t_free when they first see a new group), _active
        # counts unresolved runs, _group_pin holds a group open across
        # several run_async calls (pool.group()).
        self._submit_lock = threading.Lock()
        self._epoch = 0
        self._group = 0
        self._group_pin = 0
        self._group_t0_wall = 0.0
        self._active = 0
        # elastic membership (DESIGN.md §12): per-worker status plus the
        # scripted departure/drain instants, each bound to the group whose
        # timeline they fire on.  n_workers is the total slot count — ids
        # only grow; a departed worker keeps its id forever.
        self._status: dict[int, str] = {w: "alive" for w in range(n_workers)}
        self._leave_at: dict[int, tuple[int, float]] = {}
        self._drain_at: dict[int, tuple[int, float]] = {}
        self.membership_log: list[tuple[str, int]] = []
        # in-flight runs (epoch -> (ctx, state)): immediate removal posts
        # its failure events to these
        self._live: dict[int, tuple] = {}
        self._inbox: list[queue.Queue] = [queue.Queue() for _ in range(n_workers)]
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(w,), daemon=True,
                             name=f"cocoi-worker-{w}")
            for w in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for box in self._inbox:
            box.put(_STOP)
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @contextlib.contextmanager
    def group(self):
        """Pin one shared virtual timeline over several ``run_async`` calls.

        Runs submitted inside the ``with`` block contend for the workers on
        a single group timeline: per-worker ``t_free`` persists from run to
        run, so a worker busy with one run's piece delays another run's
        dispatch (visible as late ``t_dispatch``).  Enter a group while the
        pool is idle — pinning joins the current group if runs are still
        active.  Nesting keeps the outer group.
        """
        with self._submit_lock:
            self._group_pin += 1
            if self._group_pin == 1 and self._active == 0:
                self._group += 1
                self._group_t0_wall = self.clock.now()
        try:
            yield self
        finally:
            with self._submit_lock:
                self._group_pin -= 1

    # -- elastic membership (DESIGN.md §12) --------------------------------
    def add_worker(self) -> int:
        """Commission a brand-new worker; returns its id (ids only grow).

        The joiner is dispatchable immediately for *new* runs; runs already
        in flight never re-target it (their master state was sized at
        submit), so a join can land mid-run without racing the merge —
        rateless executors hand joiners fresh pieces explicitly
        (``extra_pieces``).
        """
        with self._submit_lock:
            w = self.n_workers
            self.n_workers += 1
            self._status[w] = "alive"
            self._inbox.append(queue.Queue())
            th = threading.Thread(target=self._worker_loop, args=(w,),
                                  daemon=True, name=f"cocoi-worker-{w}")
            self._threads.append(th)
            self.membership_log.append(("join", w))
        th.start()
        return w

    def drain(self, w: int, *, at: float | None = None) -> None:
        """Stop dispatching to ``w``; everything already queued on it still
        completes (nothing is lost, so no failure fires).  ``at`` scripts
        the drain at a group-relative virtual time: re-dispatches detected
        before ``at`` may still target ``w``, later ones avoid it."""
        with self._submit_lock:
            s = self._status.get(w)
            if s is None:
                raise KeyError(f"unknown worker {w}")
            if s != "alive":
                raise ValueError(f"worker {w} is not alive (status={s!r})")
            if at is not None:
                if not self.clock.virtual:
                    raise ValueError("scripted drain (at=) needs a virtual "
                                     "clock; real-clock pools drain now")
                self._drain_at[w] = (self._sched_group(), float(at))
            self._status[w] = "draining"
            self.membership_log.append(("drain", w))

    def remove_worker(self, w: int, *, at: float | None = None) -> None:
        """Permanently remove ``w``; in-flight pieces fail through the
        normal re-dispatch path.

        ``at`` (virtual clocks only) scripts the departure at that
        group-relative virtual time: pieces finishing by ``at`` still
        count, later ones are lost with detection at ``at`` itself — the
        worker posts the failure, keeping the merge deterministic.  With
        ``at=None`` the removal is immediate: a virtual pool must be idle
        (no deterministic "now" exists mid-run — script it instead), a
        real-clock pool posts a failure to every in-flight run at the
        current group-relative time.
        """
        with self._submit_lock:
            s = self._status.get(w)
            if s is None:
                raise KeyError(f"unknown worker {w}")
            if s in ("removed", "leaving"):
                raise ValueError(f"worker {w} already removed (status={s!r})")
            if at is not None:
                if not self.clock.virtual:
                    raise ValueError("scripted removal (at=) needs a virtual"
                                     " clock; real-clock pools remove now")
                self._status[w] = "leaving"
                self._leave_at[w] = (self._sched_group(), float(at))
            else:
                if self.clock.virtual and self._active > 0:
                    raise ValueError(
                        "cannot remove a worker mid-run on a virtual clock "
                        "without at=: no deterministic removal time exists "
                        "— script it (remove_worker(w, at=t))")
                self._status[w] = "removed"
                for epoch, (ctx, st) in list(self._live.items()):
                    if w >= len(st.pending):
                        continue  # w joined after this run; holds no pieces
                    t_rm = max((self.clock.now() - ctx.t0_wall)
                               / max(self.time_scale, 1e-12), 0.0)
                    ctx.post(_Event("failure", epoch, w, -1, t_rm))
            self.membership_log.append(("remove", w))

    def worker_status(self, w: int) -> str:
        """'alive' | 'draining' | 'leaving' (scripted departure pending) |
        'removed'."""
        try:
            return self._status[w]
        except KeyError:
            raise KeyError(f"unknown worker {w}") from None

    def alive_workers(self) -> list[int]:
        """Workers with status 'alive' — lame ducks (draining / scripted
        leavers) excluded."""
        with self._submit_lock:
            return [w for w in range(self.n_workers)
                    if self._status[w] == "alive"]

    def dispatch_preview(self, restrict: Sequence[int] | None = None
                         ) -> list[int]:
        """Workers a run submitted *now* would dispatch to (scripted
        leavers/drainers whose departure binds to the upcoming timeline
        included — they are live until their instant).  ``restrict``
        intersects with a caller-held membership snapshot (the fixed-fleet
        executors' surviving-subset view)."""
        with self._submit_lock:
            cand = self._members_for_group(self._sched_group())
        if restrict is not None:
            allowed = {int(v) for v in restrict}
            cand = [w for w in cand if w in allowed]
        return cand

    def _sched_group(self) -> int:
        """Group a scripted membership event binds to: the open group when
        one is active/pinned, else the next group a submission creates.
        Callers hold _submit_lock."""
        if self._group_pin > 0 or self._active > 0:
            return self._group
        return self._group + 1

    def _members_for_group(self, g: int) -> list[int]:
        """Dispatchable workers on group g's timeline.  Callers hold
        _submit_lock."""
        out = []
        for w in range(self.n_workers):
            s = self._status[w]
            if s == "alive":
                out.append(w)
            elif s == "leaving" and self._leave_at[w][0] >= g:
                out.append(w)   # departs later on this very timeline
            elif s == "draining" and self._drain_at.get(w, (-1, 0.0))[0] >= g:
                out.append(w)   # scripted drain: still open for dispatch
        return out

    def _accepts_redispatch(self, v: int, group: int, t_detect: float) -> bool:
        """May a piece detected-lost at ``t_detect`` be re-placed on v?
        Not on removed/draining workers, nor past a scripted drain or
        departure instant on this group's timeline.  (Re-placing *before*
        a scripted departure is allowed: if the piece loses the race the
        departure fails it and the next round moves it on — each such
        round lands the leaver in ``st.dead``, so the loop terminates.)
        Callers hold _submit_lock."""
        s = self._status.get(v)
        if s == "alive":
            return True
        if s == "leaving":
            g, t = self._leave_at[v]
            return g > group or (g == group and t_detect < t)
        if s == "draining":
            d = self._drain_at.get(v)
            if d is None:
                return False
            g, t = d
            return g > group or (g == group and t_detect < t)
        return False

    # -- worker side -------------------------------------------------------
    def _worker_loop(self, w: int) -> None:
        group, t_free = -1, 0.0
        stream = None  # this worker's own CUDA stream (_run_piece)
        # per-run progress within the current group: epoch -> [done, failed]
        runs: dict[int, list] = {}
        while True:
            item = self._inbox[w].get()
            if item is _STOP:
                return
            ctx, piece = item
            if ctx.group != group:  # new shared timeline
                group, t_free, runs = ctx.group, 0.0, {}
            prog = runs.setdefault(ctx.epoch, [0, False])
            if prog[1] or (not ctx.clock.virtual and ctx.cancel.is_set()):
                # a failed worker serves nothing further for that run; a
                # cancelled real-clock run drops its undispatched pieces.
                # Virtual mode never skips on cancel: whether the cancel
                # lands before this dequeue is a wall race, and skipping
                # would fork the group's shared timeline on it.
                continue
            if self._status.get(w) == "removed":
                # immediate removal: the master already posted this run's
                # failure; serve nothing further
                continue
            leave = self._leave_at.get(w)
            if leave is not None and ctx.group >= leave[0]:
                # scripted departure (virtual clocks): pieces finishing by
                # the departure instant still count; the first too-late
                # piece posts the failure AT that instant — deterministic
                # because this thread posts serially with monotone t — and
                # the worker serves nothing further for the run (prog[1]).
                t_rm = leave[1] if ctx.group == leave[0] else 0.0
                dur = self._duration(ctx, w, piece)
                if max(t_free, ctx.start_at, piece.not_before) + dur > t_rm:
                    prog[1] = True
                    ctx.post(_Event("failure", ctx.epoch, w, piece.idx, t_rm))
                    continue
            fail_at = ctx.faults.fails_at(w)
            if fail_at is not None and prog[0] >= fail_at:
                # die on this piece; detection at the would-be completion
                # (core/runtime.py failure semantics)
                dur = self._duration(ctx, w, piece)
                t_detect = max(t_free, ctx.start_at, piece.not_before) + dur
                prog[1] = True
                if not ctx.clock.virtual:
                    self._sleep_until(ctx, t_detect)
                ctx.post(_Event("failure", ctx.epoch, w, piece.idx, t_detect))
                continue
            try:
                t0 = time.perf_counter()
                # the real subtask compute, on this worker's own stream
                with span("pool.piece"):
                    result, stream = _run_piece(piece.fn, ctx.handoff,
                                                stream)
                elapsed = time.perf_counter() - t0
            except Exception as e:  # master re-raises
                ctx.post(_Event("error", ctx.epoch, w, piece.idx, t_free,
                                payload=e))
                prog[1] = True
                continue
            dur = self._duration(ctx, w, piece, measured=elapsed)
            stages = self._stage_durations(ctx, w, piece)
            t_start = max(t_free, ctx.start_at, piece.not_before)
            t_fin = t_start + dur
            t_free, prog[0] = t_fin, prog[0] + 1
            if not ctx.clock.virtual:
                if not self._sleep_until(ctx, t_fin):
                    continue  # cancelled mid-sleep: drop the late result
            ctx.post(_Event("arrival", ctx.epoch, w, piece.idx, t_fin,
                            payload=result, t_start=t_start, stages=stages))

    def _duration(self, ctx: _RunCtx, w: int, piece: Piece, *,
                  measured: float | None = None) -> float:
        if ctx.delay is not None:
            base = ctx.delay.piece_time(w, piece.idx)
        else:
            base = measured if measured is not None else 0.0
        return max(base * ctx.faults.slowdown(w), _MIN_DUR)

    def _stage_durations(self, ctx: _RunCtx, w: int, piece: Piece) -> tuple:
        """Per-layer durations of a multi-layer piece, when the delay model
        exposes them; straggling scales every stage uniformly."""
        if ctx.delay is None or not hasattr(ctx.delay, "stage_times"):
            return ()
        sl = ctx.faults.slowdown(w)
        return tuple(s * sl for s in ctx.delay.stage_times(w, piece.idx))

    def _sleep_until(self, ctx: _RunCtx, t_virtual: float) -> bool:
        """Real mode: land this event at wall time t0 + t_virtual*scale."""
        target = ctx.t0_wall + t_virtual * ctx.time_scale
        return ctx.clock.sleep(target - ctx.clock.now(), cancel=ctx.cancel)

    # -- master side -------------------------------------------------------
    def run(
        self,
        pieces: Sequence[Callable[[], Any]],
        until: Callable[[list[int]], list[int] | None],
        *,
        assignment: Sequence[int] | None = None,
        fault_plan: FaultPlan | None = None,
        delay_model: DelayModel | None = None,
        viable: Callable[[list[int]], bool] | None = None,
        start_at: float = 0.0,
    ) -> tuple[dict[int, Any], RunReport]:
        """Execute ``pieces`` across the workers until ``until`` accepts.

        ``until`` sees the arrived piece ids in (virtual) arrival order and
        returns the consuming subset, or None to keep waiting — the coded
        executor's rule is "the smallest decodable prefix".  ``assignment``
        gives per-worker piece *counts* (``hetero.allocate_pieces`` output:
        worker w runs ``assignment[w]`` consecutive pieces); default is
        round-robin.

        ``viable(ids)`` asks "could ``until`` ever accept if exactly the
        pieces in ``ids`` arrive?" (the executor passes the scheme's
        ``decodable``).  It gates re-dispatch after a failure: lost pieces
        are re-executed on live workers only when the still-obtainable set
        is not viable — otherwise redundancy absorbs the failure, exactly
        like core/runtime.py's simulator.  Without it every lost piece is
        re-dispatched.  Returns ({piece id: result} for the consumed
        subset, :class:`RunReport`).
        """
        return self.run_async(pieces, until, assignment=assignment,
                              fault_plan=fault_plan, delay_model=delay_model,
                              viable=viable, start_at=start_at).result()

    def run_async(
        self,
        pieces: Sequence[Callable[[], Any]],
        until: Callable[[list[int]], list[int] | None],
        *,
        assignment: Sequence[int] | None = None,
        fault_plan: FaultPlan | None = None,
        delay_model: DelayModel | None = None,
        viable: Callable[[list[int]], bool] | None = None,
        start_at: float = 0.0,
        workers: Sequence[int] | None = None,
        extra_pieces: Sequence[tuple] | None = None,
    ) -> RunHandle:
        """Dispatch ``pieces`` immediately and return a :class:`RunHandle`.

        Several handles may be in flight at once; resolve each with
        ``handle.result()`` (in any order — events are per-run).  Inside a
        ``pool.group()`` the runs contend on one shared worker timeline;
        otherwise each submission starts a fresh one.  ``start_at`` gates
        every piece of the run to begin no earlier than that group-relative
        virtual time — the executor's chaining hook for dependent runs.

        ``workers`` restricts the candidate set (intersected with the
        currently dispatchable members) — fixed-fleet executors pass their
        membership snapshot so a joiner never absorbs pieces it has no
        resident partition for.  ``extra_pieces`` is a sequence of
        ``(fn, worker, not_before)`` rateless extras: piece ids continue
        after ``len(pieces)``, each pinned to one (alive) worker and gated
        to start no earlier than ``not_before`` — how late joiners receive
        fresh LT pieces mid-trace without touching resident partitions.
        """
        faults = fault_plan or self.fault_plan
        delay = (delay_model if delay_model is not None
                 else self.delay_model)
        if self.clock.virtual and delay is None:
            raise ValueError(
                "a virtual clock needs a DelayModel: with measured compute "
                "times as virtual durations the run would be OS-scheduling "
                "dependent, defeating the deterministic clock")
        n = len(pieces)
        extras = list(extra_pieces or [])
        thunks: dict[int, Callable[[], Any]] = {
            i: fn for i, fn in enumerate(pieces)}
        wall0 = time.perf_counter()
        events: queue.Queue[_Event] = queue.Queue()
        handoff = _cuda_handoff()  # on the caller's (master's) stream
        with self._submit_lock:
            if self._group_pin == 0 and self._active == 0:
                self._group += 1  # fresh timeline for an unpinned lone run
                self._group_t0_wall = self.clock.now()
            # candidate workers resolve UNDER the lock, against the group
            # this run actually lands on — membership may have changed
            # since the caller last looked.
            cand = self._members_for_group(self._group)
            if workers is not None:
                allowed = {int(v) for v in workers}
                bad = sorted(v for v in allowed
                             if v < 0 or v >= self.n_workers)
                if bad:
                    raise ValueError(f"unknown workers {bad} in workers=")
                cand = [v for v in cand if v in allowed]
            if not cand:
                raise Undecodable(
                    "no dispatchable workers: every candidate is removed, "
                    "draining, or outside the requested workers= subset")
            owner = self._initial_assignment(n, assignment, cand)
            gates: dict[int, float] = {}
            for j, (fn, w_x, nb) in enumerate(extras):
                w_x = int(w_x)
                if self._status.get(w_x) != "alive":
                    raise ValueError(
                        f"extra-piece target {w_x} is not alive "
                        f"(status={self._status.get(w_x)!r})")
                owner[n + j] = w_x
                thunks[n + j] = fn
                gates[n + j] = float(nb)
            self._epoch += 1
            self._active += 1
            ctx = _RunCtx(self._epoch, self._group, threading.Event(),
                          faults, delay, self.clock, self.time_scale,
                          self._group_t0_wall, float(start_at), events.put,
                          handoff)
            # master state.  Receipt-time state (pending / arrived / last_t)
            # is OS-scheduling dependent and is used ONLY for the safe-merge
            # bound and liveness; every decision that shapes the run (decode
            # subset, re-dispatch targets) reads processing-time state,
            # which the time-ordered merge makes deterministic.  Sized at
            # submit: workers added later are invisible to this run.
            st = _MasterState(owner=owner, thunks=thunks,
                              pending=[set() for _ in range(self.n_workers)],
                              last_t=[0.0] * self.n_workers,
                              proc_t=[0.0] * self.n_workers)
            for i, w in owner.items():
                st.pending[w].add(i)
            for w in range(self.n_workers):
                for i in sorted(st.pending[w]):
                    self._inbox[w].put((ctx, Piece(
                        i, thunks[i], not_before=gates.get(i, 0.0))))
                    self.dispatch_count += 1
            self._live[ctx.epoch] = (ctx, st)
        report = RunReport(0.0, 0.0, [], [], [], [], [], dict(owner),
                           t_submit=float(start_at))
        return RunHandle(self, ctx, st, until, viable, report,
                         n + len(extras), wall0, events)

    def _collect(self, h: RunHandle) -> tuple[dict[int, Any], RunReport]:
        """Master loop for one submitted run (RunHandle.result); each wait
        for a worker's event is a ``repro.pool.wait`` span, as each piece
        a worker runs is a ``repro.pool.piece`` one on its thread."""
        st, ctx, report, until, viable = h._st, h._ctx, h._report, h._until, \
            h._viable
        try:
            while True:
                done = self._drain_safe(st, until, viable, report, ctx)
                if done is not None:
                    report.t_complete = done
                    report.wall_s = time.perf_counter() - h._wall0
                    report.cancelled = sorted(
                        set(range(h._n)) - set(st.order))
                    if self.clock.virtual and isinstance(self.clock,
                                                         FakeClock):
                        self.clock.advance(done)
                    if self.trace_sink is not None:
                        self._emit_spans(report)
                    return ({i: st.results[i] for i in report.subset},
                            report)
                if not any(st.pending) and not st.heap:
                    if st.lost:
                        # backstop: viable() was optimistic (or absent) and
                        # the pool idled — re-execute what was lost
                        self._redispatch(st, ctx, report)
                        continue
                    raise RuntimeError(
                        "pool exhausted: every piece arrived but the "
                        f"completion rule never accepted (arrived={st.order})")
                with span("pool.wait"):
                    ev = self._next_event(h._events)
                if ev.kind == "error":
                    raise RuntimeError(
                        f"worker {ev.worker} raised on piece {ev.piece}"
                    ) from ev.payload
                st.last_t[ev.worker] = max(st.last_t[ev.worker], ev.t)
                if ev.kind == "arrival":
                    st.arrived.add(ev.piece)
                    st.pending[ev.worker].discard(ev.piece)
                heapq.heappush(st.heap, (ev.t, ev.worker, ev.piece, ev))
        finally:
            ctx.cancel.set()  # abort real-clock stragglers
            with self._submit_lock:
                self._active -= 1
                self._live.pop(ctx.epoch, None)

    def _emit_spans(self, report: "RunReport") -> None:
        """Feed one resolved run's piece timings to the trace sink.

        Times are group-relative; the sink's ``origin`` (0.0 when absent)
        places them on the caller's timeline.  Stage phases are laid out
        cumulatively from the dispatch instant, but only when the stage
        sum fits inside the round trip — pipelined chunked stages overlap
        in time and cannot honestly be placed end-to-end.
        """
        from ..telemetry.trace import Span
        sink = self.trace_sink
        origin = float(getattr(sink, "origin", 0.0))
        for tm in report.timings:
            tid = f"worker-{tm.worker}"
            sink.span(Span("piece", "pool", origin + tm.t_dispatch,
                           tm.t_compute, tid, {"piece": tm.piece}))
            if tm.stages and sum(tm.stages) <= tm.t_compute * (1 + 1e-9) + 1e-12:
                t = origin + tm.t_dispatch
                for j, dur in enumerate(tm.stages):
                    sink.span(Span("phase", "pool", t, dur, tid,
                                   {"piece": tm.piece, "stage": j}))
                    t += dur

    def _initial_assignment(self, n: int, counts,
                            cand: Sequence[int]) -> dict[int, int]:
        """Piece -> worker over the dispatchable candidates only; counts
        (hetero.allocate_pieces output) map positionally onto ``cand``."""
        owner: dict[int, int] = {}
        if counts is None:
            for i in range(n):
                owner[i] = cand[i % len(cand)]
            return owner
        counts = [int(c) for c in counts]
        if len(counts) != len(cand) or sum(counts) != n or min(counts) < 0:
            raise ValueError(
                f"assignment {counts} must have one count >= 0 per "
                f"dispatchable worker ({len(cand)}) summing to the piece "
                f"count ({n})")
        i = 0
        for w, c in zip(cand, counts):
            for _ in range(c):
                owner[i] = w
                i += 1
        return owner

    def _next_event(self, events: "queue.Queue[_Event]") -> _Event:
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                return events.get(timeout=max(deadline - time.monotonic(),
                                              0.01))
            except queue.Empty:
                raise RuntimeError(
                    f"pool stalled: no event within {self.timeout_s}s "
                    "(dead workers without redundancy?)") from None

    def _drain_safe(self, st: _MasterState, until, viable, report,
                    ctx) -> float | None:
        """Process every heap event that is safe in virtual-time order;
        return the accepting arrival's time when ``until`` fires."""
        while st.heap:
            t, _w, _p, ev = st.heap[0]
            if self.clock.virtual and not self._safe(t, st):
                return None
            heapq.heappop(st.heap)
            st.proc_t[ev.worker] = max(st.proc_t[ev.worker], ev.t)
            if ev.kind == "failure":
                self._on_failure(ev, st, viable, report, ctx)
                continue
            st.results[ev.piece] = ev.payload
            if ev.piece not in st.order:
                st.order.append(ev.piece)
                report.arrivals.append(Arrival(ev.worker, ev.piece, ev.t))
                report.timings.append(PieceTiming(
                    ev.worker, ev.piece, ev.t_start, ev.t - ev.t_start, ev.t,
                    stages=ev.stages))
                subset = until(list(st.order))
                if subset is not None:
                    report.subset = list(subset)
                    return max(report.arrivals[st.order.index(p)].t
                               for p in subset)
        return None

    def _safe(self, t: float, st: _MasterState) -> bool:
        """No still-pending live worker can emit an event earlier than t:
        per-worker timelines are strictly increasing, so worker w's next
        event lands strictly after last_t[w]."""
        return all(
            t <= st.last_t[w]
            for w in range(len(st.pending))  # submit-time snapshot, not
            if st.pending[w] and w not in st.dead  # the (growable) pool
        )

    def _on_failure(self, ev, st: _MasterState, viable, report, ctx) -> None:
        w = ev.worker
        st.dead.add(w)
        report.failures.append((w, ev.t))
        for p in st.pending[w]:
            st.lost[p] = ev.t
        st.pending[w].clear()
        if not st.lost:
            return
        # still-obtainable pieces: arrived (received or processed) plus
        # pending on live workers.  Each piece sits on exactly one side of
        # the receipt race, so the UNION is deterministic even though the
        # two components individually are not.
        obtainable = st.arrived.union(
            *(st.pending[v] for v in range(len(st.pending))
              if v not in st.dead))
        if viable is not None and viable(sorted(obtainable)):
            return  # redundancy absorbs the failure; lost pieces ignored
        self._redispatch(st, ctx, report)

    def _redispatch(self, st: _MasterState, ctx, report) -> None:
        # bounded: each round either lands in the accepting subset or ends
        # with another worker in st.dead, so more rounds than the run ever
        # had workers (+ slack for the idle-pool backstop) means the
        # obtainable set can never satisfy the completion rule.
        st.redispatch_rounds += 1
        if st.redispatch_rounds > len(st.pending) + 4:
            raise Undecodable(
                f"pieces {sorted(st.lost)} still lost after "
                f"{st.redispatch_rounds - 1} re-dispatch rounds — the "
                "obtainable piece set can never decode")
        with self._submit_lock:
            # live = submit-time snapshot minus dead; joiners (index beyond
            # the snapshot) hold no resident data for this run and are
            # reachable only via extra_pieces on a NEW run.  Scripted
            # leavers/drainers stop accepting at their instant.
            live = [v for v in range(len(st.pending)) if v not in st.dead]
            cands: dict[int, list[int]] = {}
            for p in sorted(st.lost):
                t_detect = st.lost[p]
                ok = [v for v in live
                      if self._accepts_redispatch(v, ctx.group, t_detect)]
                if not ok:
                    raise Undecodable(
                        f"piece {p} lost at t={t_detect:.6g} and no "
                        "dispatchable worker remains (removed, draining, "
                        "or departed)")
                cands[p] = ok
            # deterministic spread: least-loaded candidate first, where
            # load and tie-breaks read PROCESSED state only (outstanding
            # assigned pieces, last processed event time) — receipt-order
            # state would make the target, and with it the whole run,
            # scheduling-dependent
            load = {v: st.outstanding(v) for v in live}
            for p in sorted(st.lost):
                t_detect = st.lost[p]
                tgt = min(cands[p], key=lambda v: (load[v], st.proc_t[v], v))
                load[tgt] += 1
                st.pending[tgt].add(p)
                src = st.owner[p]
                st.owner[p] = tgt
                report.assignment[p] = tgt
                report.redispatched.append((p, src, tgt))
                self._inbox[tgt].put(
                    (ctx, Piece(p, st.thunks[p], not_before=t_detect)))
                self.dispatch_count += 1
        st.lost.clear()
