"""Decode-at-the-k-th-arrival coded execution on a WorkerPool.

``CodedExecutor`` turns the paper's §II-B pipeline into a live run: the n
coded subtasks are dispatched across the pool, the master accepts the
*smallest decodable prefix* of the arrival stream (exactly k arrivals for
MDS — eq. 4; all n for uncoded; a rank-k prefix for LT) and decodes it via
the scheme's ``decode_from``, cancelling every straggler past that point.
This is what makes the latency claim testable end-to-end: completion time
is the k-th worker's finish, not the n-th.

Heterogeneous workers (``core/hetero.py``): pass ``speeds=`` (or a
precomputed ``assignment=`` of per-worker piece counts from
``allocate_pieces``) and fast workers receive proportionally more coded
pieces, each executed back-to-back on its worker's serial timeline.

Overlapped runs: ``run_async`` dispatches a run and
returns an :class:`ExecHandle` immediately, so independent runs — a step's
prefill length-buckets against its decode, or the next segment's dispatch
against the current one's tail — interleave on the same pool.  Dependent
runs chain instead: inside ``with ex.chain():`` each run is gated to start
at the previous run's ``t_complete`` on the group timeline.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Sequence

import torch

from ..core.schemes import CodingScheme, decode_blocks
from ..telemetry.trace import span
from .clock import Clock
from .faults import ChurnSchedule, DelayModel, FaultPlan
from .pool import RunHandle, RunReport, WorkerPool

__all__ = ["CodedExecutor", "ExecHandle", "decodable_prefix"]


def decodable_prefix(scheme: CodingScheme, order: Sequence[int]) -> list[int] | None:
    """Smallest decodable prefix of the arrival order, or None.

    Checking prefixes (not subsets) keeps the semantics literal: the master
    decodes the moment the arrival *stream* first becomes decodable.
    """
    if len(order) < scheme.min_done:
        return None
    if not scheme.decodable(list(order)):
        return None  # even everything arrived so far is not enough
    for m in range(scheme.min_done, len(order) + 1):
        prefix = list(order[:m])
        if scheme.decodable(prefix):
            return prefix
    return None  # unreachable: the full order was decodable


class ExecHandle:
    """One in-flight coded run; ``result()`` collects, decodes, and books
    the run into the executor's telemetry (last_report / run_count /
    on_report / chain gate) — in *resolution* order, which for overlapped
    runs is the caller's join order."""

    def __init__(self, ex: "CodedExecutor", scheme: CodingScheme,
                 handle: RunHandle, decode_chunks: int):
        self._ex = ex
        self._scheme = scheme
        self._handle = handle
        self._decode_chunks = decode_chunks
        self._out: torch.Tensor | None = None

    @property
    def report(self) -> RunReport:
        return self._handle.report

    def cancel(self) -> None:
        self._handle.cancel()

    def result(self) -> torch.Tensor:
        if self._out is not None:
            return self._out
        results, report = self._handle.result()
        ex, scheme = self._ex, self._scheme
        ex.last_report = report
        ex.run_count += 1
        if ex._chain_t is not None:
            ex._chain_t = max(ex._chain_t, report.t_complete)
        if ex.trace_sink is not None:
            from ..telemetry.trace import Span
            origin = float(getattr(ex.trace_sink, "origin", 0.0))
            ex.trace_sink.span(Span(
                "run", "exec", origin + report.t_submit,
                max(report.t_complete - report.t_submit, 0.0), "pool",
                {"n": scheme.n, "k": scheme.k,
                 "pieces": len(report.assignment),
                 "redispatches": len(report.redispatched),
                 "decoded": len(report.subset)}))
        if ex.on_report is not None:
            ex.on_report(report)
        subset = report.subset
        # arrivals were posted after their stream was synchronised
        # (pool._wait_for_device), so the values exist; they stay on the
        # device they were computed on
        with span("coded.decode"):
            stacked = torch.stack([torch.as_tensor(results[i])
                                   for i in subset])
            self._out = decode_blocks(scheme, subset, stacked,
                                      chunks=self._decode_chunks)
        return self._out


class CodedExecutor:
    """A WorkerPool plus the coded completion/decode rule.

    Owns its pool unless one is injected; reusable across many layer
    executions (the serving engine holds exactly one).  After each run the
    evidence trail is kept in ``last_report``.
    """

    def __init__(self, n_workers: int | None = None, *,
                 pool: WorkerPool | None = None,
                 clock: Clock | None = None,
                 delay_model: DelayModel | None = None,
                 fault_plan: FaultPlan | None = None,
                 time_scale: float = 1.0, timeout_s: float = 120.0,
                 elastic: bool = False):
        if pool is None:
            if n_workers is None:
                raise ValueError("need n_workers or an existing pool")
            pool = WorkerPool(n_workers, clock=clock, delay_model=delay_model,
                              fault_plan=fault_plan, time_scale=time_scale,
                              timeout_s=timeout_s)
        elif n_workers is not None and n_workers != pool.n_workers:
            raise ValueError(f"n_workers={n_workers} != pool.n_workers="
                             f"{pool.n_workers}")
        self.pool = pool
        # elastic membership: an elastic executor re-sizes
        # n to the live fleet via plan_matmul and dispatches to whoever is
        # currently a member (joiners included).  A fixed-fleet executor
        # (the default) pins dispatch to the workers alive at construction:
        # a joiner holds no resident partition of its model, so handing it
        # pieces would be incoherent — under churn it degrades to the
        # SURVIVING SUBSET of its original fleet instead.
        self.elastic = bool(elastic)
        self._base_workers = (None if self.elastic
                              else list(pool.alive_workers()))
        self.last_report: RunReport | None = None
        # total coded runs this executor has started; with pool.dispatch_count
        # this gives dispatches-per-run, the batching amortization evidence
        self.run_count = 0
        # optional per-run sink: called with each completed RunReport.  The
        # serving scheduler hooks this to credit every run's (virtual)
        # completion time and dispatch cost to the step that started it.
        self.on_report: Callable[[RunReport], None] | None = None
        # optional telemetry.TraceSink: each booked run emits one "run"
        # span covering submit -> accepting arrival (group-relative plus
        # the sink's origin).  Run spans fire BEFORE on_report, so a
        # scheduler hook that advances the sink's origin never displaces
        # the run that produced the report.
        self.trace_sink = None
        # virtual gate for the next chained run (None = chaining off)
        self._chain_t: float | None = None

    def close(self) -> None:
        self.pool.close()

    def __enter__(self) -> "CodedExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @contextlib.contextmanager
    def chain(self, start: float = 0.0):
        """Gate the runs started inside the block into a dependency chain:
        each run starts (in group-relative virtual time) no earlier than
        the previous chained run's ``t_complete`` — how the scheduler
        models a lane's serial GEMM sequence while *other* chains overlap
        it on the same ``pool.group()`` timeline.  Not reentrant."""
        prev = self._chain_t
        self._chain_t = float(start)
        try:
            yield self
        finally:
            self._chain_t = prev

    def ensure_armed(self, sizes) -> None:
        """Telemetry hook: declare the next run's work content (one
        ``PhaseSizes`` — or a per-layer sequence for segment chains)
        UNLESS the caller already armed something more specific.  A no-op
        here; an adaptive executor overrides it to feed its planner —
        execution layers call it unconditionally so segment runs train
        the estimator without caring which executor they were handed."""

    def run_op(self, op) -> torch.Tensor:
        """``ExecBackend`` entry point (dist/backend.py): encode the op's
        source stack eagerly, thunk one piece each, and delegate to
        ``self.run`` — so a subclass's run override (probing,
        auto-assignment, report observation) composes unchanged."""
        from ..core.coded_conv import _encode_partitions, conv2d
        from ..kernels.skinny_gemm import skinny_gemm

        scheme = op.scheme
        w = op.weight()  # the source weight, cast once per run
        if op.kind == "matmul":
            k, t_p, d = op.x.shape
            coded_in = scheme.encode(op.x.reshape(k, -1)).reshape(scheme.n, t_p, d)
            # the piece GEMM is the hand-written kernel (its split-K GEMV
            # regime for t_p <= 16, its tiled regime above), with one
            # reduction order fixed by t_p's regime and d_in — a library
            # `@` picks a shape-dependent algorithm, which breaks
            # byte-for-byte equality across backends
            fns = [lambda i=i: skinny_gemm(coded_in[i], w)
                   for i in range(scheme.n)]
        else:
            coded_in = _encode_partitions(scheme, op.x)
            fns = [
                lambda i=i: conv2d(coded_in[i], w, op.spec.stride)
                for i in range(scheme.n)
            ]
        return self.run(scheme, fns, assignment=op.assignment,
                        decode_chunks=op.decode_chunks)

    def _elastic_n(self, scheme: CodingScheme) -> int | None:
        """New n for the next run, or None when unchanged / not elastic.
        The fleet must still cover k — fewer members than k cannot decode,
        so the scheme keeps its n and survives on re-dispatch instead."""
        if not self.elastic:
            return None
        alive = len(self.pool.dispatch_preview())
        if alive >= scheme.k and alive != scheme.n:
            return alive
        return None

    def plan_matmul(self, scheme: CodingScheme, scheme_name: str,
                    n_tokens: int, d_in: int, d_out: int):
        """Pre-dispatch re-plan hook: ``(n_new, k_new, assignment)`` with
        None for "keep what you have" (the model layer consumes this).

        The base executor only reacts to MEMBERSHIP: when elastic and the
        live fleet no longer matches scheme.n, n follows the fleet.  k is
        scheme-typed — rateless codes (LT) keep k (extra members just mean
        more coded rows, no re-encode), fixed-structure codes re-solve
        their own ``redundancy_policy`` because their generator bakes n in.
        An adaptive executor overrides this with the profile-driven k°.
        """
        n_new = self._elastic_n(scheme)
        if n_new is None:
            return None, None, None
        if getattr(scheme, "rateless", False):
            return n_new, None, None
        return n_new, type(scheme).redundancy_policy(n_new), None

    def run_elastic(
        self,
        scheme: CodingScheme,
        piece_fns: Sequence[Callable[[], Any]],
        *,
        churn: ChurnSchedule,
        fresh_piece: Callable[[CodingScheme, int], Callable[[], Any]] | None
            = None,
        pieces_per_join: int = 1,
        assignment: Sequence[int] | None = None,
        fault_plan: FaultPlan | None = None,
        delay_model: DelayModel | None = None,
        decode_chunks: int = 1,
        start_at: float | None = None,
    ) -> ExecHandle:
        """One coded run under a scripted mid-run churn trace.

        Joins are applied first (the pool grows), departures/drains are
        scripted at their virtual instants, and — for rateless schemes —
        each joiner receives ``pieces_per_join`` FRESH coded pieces via the
        scheme's ``extend`` (piece ids continue past ``scheme.n``; resident
        workers' pieces are untouched, no re-encode).  ``fresh_piece(ext,
        idx)`` must build the thunk computing coded row ``idx`` of the
        extended scheme ``ext``.  Fixed-n schemes ignore ``fresh_piece``:
        their joiners idle and the run lives on its surviving subset.
        Returns an :class:`ExecHandle` whose decode uses the extended
        scheme.
        """
        if len(piece_fns) != scheme.n:
            raise ValueError(
                f"scheme.n={scheme.n} but got {len(piece_fns)} pieces")
        base = list(self.pool.alive_workers())
        ext = scheme
        extras: list[tuple[Callable[[], Any], int, float]] = []
        for e in churn.events:
            if e.action == "join":
                w = self.pool.add_worker()
                if fresh_piece is not None and getattr(scheme, "rateless",
                                                       False):
                    for _ in range(int(pieces_per_join)):
                        ext = ext.extend(1)
                        idx = ext.n - 1
                        extras.append((fresh_piece(ext, idx), w, e.t))
            elif e.action == "remove":
                self.pool.remove_worker(e.worker, at=e.t)
            else:
                self.pool.drain(e.worker, at=e.t)
        until = lambda order: decodable_prefix(ext, order)
        if start_at is None:
            start_at = self._chain_t if self._chain_t is not None else 0.0
        handle = self.pool.run_async(
            piece_fns,
            until,
            assignment=assignment,
            fault_plan=fault_plan,
            delay_model=delay_model,
            viable=lambda ids: ext.decodable(ids),
            start_at=start_at,
            workers=base,       # residents hold pieces; joiners get extras
            extra_pieces=extras,
        )
        return ExecHandle(self, ext, handle, int(decode_chunks))

    def run_async(
        self,
        scheme: CodingScheme,
        piece_fns: Sequence[Callable[[], Any]],
        *,
        assignment: Sequence[int] | None = None,
        speeds: Sequence[float] | None = None,
        fault_plan: FaultPlan | None = None,
        delay_model: DelayModel | None = None,
        gather_all: bool = False,
        decode_chunks: int = 1,
        start_at: float | None = None,
    ) -> ExecHandle:
        """Dispatch the n coded pieces now; decode on ``handle.result()``.

        ``start_at`` gates the run's pieces to a group-relative virtual
        time (default: the active :meth:`chain` position, else 0).
        ``decode_chunks > 1`` decodes the accepted subset incrementally per
        column block (streamed gather — the decode-matrix solve is shared,
        only the skinny GEMM is chunked; bit-identical output).
        """
        if len(piece_fns) != scheme.n:
            raise ValueError(
                f"scheme.n={scheme.n} but got {len(piece_fns)} pieces")
        if speeds is not None:
            if assignment is not None:
                raise ValueError("pass speeds= or assignment=, not both")
            from ..core.hetero import allocate_pieces

            assignment = allocate_pieces(speeds, scheme.n)
        n_pieces = len(piece_fns)
        if gather_all:
            until = (lambda order: decodable_prefix(scheme, order)
                     if len(order) >= n_pieces else None)
        else:
            until = lambda order: decodable_prefix(scheme, order)
        if start_at is None:
            start_at = self._chain_t if self._chain_t is not None else 0.0
        handle = self.pool.run_async(
            piece_fns,
            until,
            assignment=assignment,
            fault_plan=fault_plan,
            delay_model=delay_model,
            # a failure is re-dispatched only if the still-obtainable piece
            # set cannot decode (runtime.py's "ignored if enough redundancy
            # remains" semantics)
            viable=lambda ids: scheme.decodable(ids),
            start_at=start_at,
            # fixed-fleet executors never dispatch to post-construction
            # joiners (no resident partition); elastic ones take the fleet
            # as it stands
            workers=self._base_workers,
        )
        return ExecHandle(self, scheme, handle, int(decode_chunks))

    def run(
        self,
        scheme: CodingScheme,
        piece_fns: Sequence[Callable[[], Any]],
        *,
        assignment: Sequence[int] | None = None,
        speeds: Sequence[float] | None = None,
        fault_plan: FaultPlan | None = None,
        delay_model: DelayModel | None = None,
        gather_all: bool = False,
        decode_chunks: int = 1,
    ) -> torch.Tensor:
        """Execute the n coded pieces, decode at the k-th arrival.

        ``piece_fns[i]`` computes coded piece i (all outputs same shape).
        Returns the decoded sources with shape ``(scheme.k,) + piece_shape``;
        the run's :class:`RunReport` lands in ``last_report``.

        ``gather_all`` turns the run into a *probe*: the master waits for
        every piece before decoding (still from the smallest decodable
        prefix, so the result is identical), trading one run's early-exit
        saving for telemetry on every worker — with k-of-n cancellation a
        straggler never completes, so a completions-only estimator would
        otherwise keep believing whatever it last saw (survivorship bias).
        """
        return self.run_async(
            scheme, piece_fns, assignment=assignment, speeds=speeds,
            fault_plan=fault_plan, delay_model=delay_model,
            gather_all=gather_all, decode_chunks=decode_chunks).result()
