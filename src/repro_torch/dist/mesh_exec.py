"""MeshExecutor: k-of-n coded dispatch as one device program per op.

The second implementation of the :mod:`repro_torch.dist.backend` seam (the
port of ``repro.dist.mesh_exec``).  Where ``CodedExecutor`` runs pieces on
threads against a (mostly virtual) clock, ``MeshExecutor`` maps each coded
piece to one *lane* of the card's piece-lane mesh (launch/mesh.py) and runs

    encode  ->  all n piece GEMMs / convs in one launch  ->  gather  ->  decode

as one program per (op shape, scheme, fault pattern):

* **encode** — the very call the threaded backend's ``run_op`` makes
  (``scheme.encode``: the skinny-GEMM kernel for MDS/LT, a gather for
  selection schemes), so the coded inputs have the same bits.
* **pieces** — a matmul's n pieces are one launch of the skinny GEMM's
  stacked entry (``kernels.skinny_gemm.piece_gemm_stacked``), a conv's one
  launch of the conv kernel on the n-folded batch
  (``kernels.conv2d.conv2d_stacked``).  Each piece has the bits of its
  launch alone, so both backends produce bit-identical piece values.
* **decode** — the decodable subset is gathered with ``index_select`` on a
  cached device index and decoded by ``core.schemes.decode_blocks``.

On a CUDA tensor the program is captured once as a CUDA graph and every run
is a replay: the counterpart of the reference's ``jax.jit`` of its
``shard_map`` program.  A run then costs one graph launch between two timing
events, and the host does not wait for it: the caller goes on issuing the
work after it while the card runs the pieces, and the run's report is
completed from its events at the next wait the caller makes anyway
(``settle``).  The threaded backend makes n + 2 launches from n + 1 threads
and a synchronise per piece.  On a CPU tensor the same program runs eagerly
on the kernels' plain versions, and its report is booked when it returns.

k-of-n semantics in one program (the reference's DESIGN.md §13): a launch
cannot cancel a lane — every piece is computed.  "Early exit" is therefore
*algebraic*, not temporal: the decodable subset is chosen ahead of dispatch
from the executor's configured fault pattern (``order``/``dead``/
``stragglers``), exactly the subset the threaded backend's k-th-arrival
rule consumes under the same pattern, and the other lanes are never
gathered.  A dead lane's piece is modeled as *redispatched*: it re-enters
the arrival order at the very end (after stragglers), so schemes that need
every piece (uncoded) still decode — matching the thread pool, whose failed
pieces are re-run on surviving workers.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Sequence

import torch

from ..core.schemes import decode_blocks
from ..launch.mesh import (MODEL_AXIS, LocalMesh, PiecePlacementError,
                           make_local_mesh, validate_pieces)
from ..telemetry.trace import span
from .clock import RealClock
from .executor import decodable_prefix
from .pool import Arrival, RunReport, Undecodable

__all__ = ["MeshExecutor"]

# CUDA graphs one executor keeps, least recently replayed dropped first.  A
# graph owns no buffer (its program's input and output are shared by every
# weight, its intermediates are the shared pool's), so the bound is on
# graph objects: served Zamba2-1.2B keeps 9 (three token counts x three FFN
# weights), gemma-2b under load ~1,100 (54 FFN weights x ~20 token counts)
MAX_GRAPHS = 4096
# card runs whose reports may wait for a settle: a caller that never settles
# (model code called without the engine) waits for the card once this many
# are pending, so their events stay bounded.  An engine call settles at its
# copy-out, long before: a qwen3-32b call issues 192 runs
MAX_PENDING = 1024


class _MeshFleet:
    """The pool-shaped facade the serving stack expects on a backend.

    The scheduler scripts faults/delays and reads counters through
    ``executor.pool``; on a mesh there is no thread pool, so this object
    carries the counters and accepts (and ignores) the scripting fields.
    Membership is the mesh itself: workers are the ``axis`` lanes.
    """

    def __init__(self, mesh: LocalMesh, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.clock = RealClock()
        self.fault_plan = None   # assignable: scheduler _arm_step writes it
        self.delay_model = None  # assignable: scheduler reseeds it
        self.dispatch_count = 0

    def alive_workers(self) -> list[int]:
        return list(range(int(self.mesh.shape[self.axis])))

    def dispatch_preview(self) -> list[int]:
        return self.alive_workers()

    @contextlib.contextmanager
    def group(self):
        yield self

    def close(self) -> None:
        pass


def _scheme_key(scheme) -> tuple:
    return (type(scheme).__name__, scheme.n, scheme.k,
            getattr(scheme, "node_kind", None),
            getattr(scheme, "seed", None), getattr(scheme, "c", None),
            getattr(scheme, "delta", None))


@dataclasses.dataclass
class _Static:
    """A program's input and output buffers, shared by the graphs of every
    weight the program runs with and allocated outside the graphs' memory
    pool: replay after copying the op's sources into ``x``; ``out`` holds
    the decoded stack until the next replay of a graph of this program."""

    x: torch.Tensor
    out: torch.Tensor | None = None


@dataclasses.dataclass
class _Graph:
    """One captured program for one weight.  Its intermediates live in the
    executor's one graph memory pool and are free for the next capture to
    reuse (runs never overlap: the host does not wait for a replay, but
    every replay, input copy and output clone is issued on the one stream
    ``run_op`` admits, so the card runs them in issue order; and nothing
    reads an intermediate after its replay), so a graph keeps no memory of
    its own alive."""

    graph: "torch.cuda.CUDAGraph"
    # kept alive while the graph may replay: the weight whose pointer the
    # graph baked in, and the device copies of the coding matrices and
    # gather indices it reads (core/coding.py may drop its cache)
    w: torch.Tensor
    held: list


@dataclasses.dataclass
class _Pending:
    """A run issued on the card whose report waits for its end event: the
    run's time on the card is ``start.elapsed_time(end)``."""

    scheme: object
    subset: tuple
    t_submit: float
    start: "torch.cuda.Event"
    end: "torch.cuda.Event"


class MeshExecutor:
    """Coded dispatch as one device program (the ``ExecBackend`` seam).

    Parameters
    ----------
    mesh:
        The piece-lane mesh (default: ``make_local_mesh()``).
    axis:
        Which mesh axis the pieces tile.  A one-card mesh's only other
        axis, ``data``, has extent 1, so ``'model'`` is the one value that
        places more than one piece; the parameter keeps the reference's
        signature.
    order / dead / stragglers:
        The modeled fault pattern: ``order`` overrides the natural piece
        arrival order; ``dead`` pieces are redispatched (they arrive after
        everything else); ``stragglers`` arrive after all healthy pieces.
        The decodable subset — which lanes' results the decode consumes —
        is derived from this pattern with the same ``decodable_prefix``
        rule the threaded master applies at the k-th arrival.

    A program is built once per (kind, scheme, shapes, dtypes, stride,
    subset) — ``compile_count`` counts them so callers can assert the
    compile-once contract.  On the card each program is a CUDA graph per
    weight as well (a graph bakes the weight's pointer, and layers share
    shapes, not weights): ``graph_count`` counts captures,
    ``replay_count`` replays, and ``queued_runs`` the runs issued while
    the run before them was still on the card (the host ahead of it).
    """

    def __init__(self, mesh: LocalMesh | None = None, *,
                 axis: str = MODEL_AXIS,
                 order: Sequence[int] | None = None,
                 dead: Sequence[int] = (),
                 stragglers: Sequence[int] = ()):
        self.mesh = mesh if mesh is not None else make_local_mesh()
        if axis not in self.mesh.shape:
            raise PiecePlacementError(
                f"mesh has no {axis!r} axis (axes: "
                f"{tuple(self.mesh.axis_names)})")
        self.axis = axis
        self.order = None if order is None else tuple(int(p) for p in order)
        self.dead = tuple(int(p) for p in dead)
        self.stragglers = tuple(int(p) for p in stragglers)
        self.pool = _MeshFleet(self.mesh, axis)
        self.elastic = False
        self.run_count = 0
        self._last_report: RunReport | None = None
        self.on_report = None
        # optional telemetry.TraceSink.  One program has no per-piece
        # timeline — the mesh emits run-level spans ONLY, on real wall time
        self.trace_sink = None
        self.compile_count = 0
        self.graph_count = 0
        self.replay_count = 0
        self.queued_runs = 0
        # host seconds blocked on the card (the scheduler reads it as a delta
        # a step): a report asked for before its run has finished, and a CPU
        # run's span after its program returned
        self.wait_s = 0.0
        self._programs: set = set()
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._static: dict = {}
        self._pool_handle = None
        self._capture_stream = None
        self._chain_t = 0.0
        # the card's runs whose reports wait for their end events, in run
        # order; timing events free for the next run; graphs dropped past
        # MAX_GRAPHS while a replay of theirs may still be on the card; the
        # stream every replay is issued on
        self._pending: collections.deque = collections.deque()
        self._events: list = []
        self._evicted: list = []
        self._stream = None

    @property
    def last_report(self) -> RunReport | None:
        """The most recent run's report.  Read while runs are pending, it
        waits for the last of them on the card and books them all."""
        if self._pending:
            self.settle()
        return self._last_report

    @last_report.setter
    def last_report(self, report: RunReport | None) -> None:
        self._last_report = report

    # -- executor contract (dist/backend.py) --------------------------------
    def close(self) -> None:
        self.settle()
        self._programs.clear()
        self._graphs.clear()
        self._static.clear()

    def __enter__(self) -> "MeshExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @contextlib.contextmanager
    def chain(self, start: float = 0.0):
        """Causal-chain marker for API parity: successive run_ops are
        already serial (one stream on the card, eager on the CPU); nothing
        to gate."""
        prev = self._chain_t
        self._chain_t = float(start)
        try:
            yield self
        finally:
            self._chain_t = prev

    def ensure_armed(self, sizes) -> None:
        """Telemetry hook — nothing to arm (no delay model to train)."""

    def plan_matmul(self, scheme, scheme_name: str, n_tokens: int,
                    d_in: int, d_out: int):
        """No re-planning: mesh membership is fixed at construction."""
        return None, None, None

    def run(self, scheme, piece_fns, **kw):
        raise NotImplementedError(
            "MeshExecutor executes whole coded ops (run_op), not opaque "
            "piece thunks — a thunk hides the math one program must hold. "
            "Segment chains and hand-built piece functions need the "
            "threaded CodedExecutor backend.")

    # -- fault pattern -> decodable subset ----------------------------------
    def _arrival_order(self, n: int) -> list[int]:
        order = (list(self.order) if self.order is not None
                 else list(range(n)))
        if sorted(order) != list(range(n)):
            raise ValueError(
                f"order must be a permutation of range({n}), got {order}")
        dead = {p for p in self.dead if p < n}
        slow = {p for p in self.stragglers if p < n} - dead
        healthy = [p for p in order if p not in dead and p not in slow]
        # stragglers arrive after every healthy piece; dead pieces are
        # redispatched and arrive last of all (thread-pool semantics)
        return (healthy + [p for p in order if p in slow]
                + [p for p in order if p in dead])

    def _subset(self, scheme) -> tuple[int, ...]:
        sub = decodable_prefix(scheme, self._arrival_order(scheme.n))
        if sub is None:
            raise Undecodable(
                f"{type(scheme).__name__}(n={scheme.n}, k={scheme.k}) "
                f"cannot decode under dead={self.dead} "
                f"stragglers={self.stragglers} on this mesh")
        return tuple(int(p) for p in sub)

    # -- the program ---------------------------------------------------------
    @staticmethod
    def program(op, subset: Sequence[int], x: torch.Tensor) -> torch.Tensor:
        """The op's program, eagerly: the weight's cast to ``x``'s type
        (none for f32), encode (the threaded ``run_op``'s call), every
        piece in one launch, gather ``subset``, decode.  The
        reference multiplies the pieces by a 0/1 lane mask before its
        gather; ``x * 1.0`` changes no bit and the gather never reads a
        masked lane, so the mask is left out."""
        from ..core.coded_conv import _encode_partitions
        from ..core.coding import device_index
        from ..kernels.conv2d import conv2d_stacked
        from ..kernels.skinny_gemm import piece_gemm_stacked

        scheme = op.scheme
        # the weight's cast to the inputs' type runs inside the program (a
        # bf16 weight's graph holds its cast): the graph is keyed by the
        # source weight's pointer and type, and no f32 copy outlives a run
        w = op.weight()
        if op.kind == "matmul":
            k, t_p, d = x.shape
            coded = scheme.encode(x.reshape(k, -1)).reshape(scheme.n, t_p, d)
            pieces = piece_gemm_stacked(coded, w)
        else:
            coded = _encode_partitions(scheme, x)
            pieces = conv2d_stacked(coded, w, op.spec.stride)
        gathered = pieces.index_select(0, device_index(subset, pieces.device))
        return decode_blocks(scheme, list(subset), gathered)

    def _key(self, op, subset: tuple[int, ...]) -> tuple:
        stride = op.spec.stride if op.spec is not None else None
        return (op.kind, _scheme_key(op.scheme), tuple(op.x.shape),
                str(op.x.dtype), tuple(op.w.shape), str(op.w.dtype),
                stride, subset)

    def _capture(self, op, subset: tuple[int, ...], st: _Static) -> _Graph:
        """Run the program eagerly once (it builds the kernels and uploads
        the coding matrices and indices: a host-to-device copy cannot be
        captured), then capture it, its decoded stack copied into the
        program's static output.  The kernel wrappers count their calls
        in both; a replay calls no wrapper and counts in ``replay_count``
        only (the device's own record of a replay's kernels is the
        profiler's)."""
        from ..core import coding

        st.x.copy_(op.x)
        out = self.program(op, subset, st.x)
        if st.out is None:
            st.out = torch.empty_like(out)
        dev = op.x.device
        if self._pool_handle is None:
            self._pool_handle = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(device=dev)
        # what ``torch.cuda.graph`` does, without its emptying of the
        # allocator's cache before every capture: a serve under load
        # captures ~1,100 graphs, and each emptying costs a round of frees
        # and fresh allocations
        graph = torch.cuda.CUDAGraph()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool_handle)
                try:
                    st.out.copy_(self.program(op, subset, st.x))
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
        except RuntimeError as e:
            raise RuntimeError(
                f"MeshExecutor: capturing the {op.kind} program as a CUDA "
                f"graph failed ({e}); the mesh backend runs only as a "
                "graph on the card") from e
        return _Graph(graph, op.w, list(coding._DEVICE_CACHE.values()))

    def _replay(self, op, subset: tuple[int, ...], key: tuple
                ) -> torch.Tensor:
        st = self._static.get(key)
        if st is None:
            st = self._static[key] = _Static(
                torch.empty(op.x.shape, dtype=op.x.dtype, device=op.x.device))
        gkey = key + (op.w.data_ptr(),)
        g = self._graphs.get(gkey)
        if g is None:
            with span("mesh.capture"):
                g = self._capture(op, subset, st)
            self._graphs[gkey] = g
            self.graph_count += 1
            while len(self._graphs) > MAX_GRAPHS:
                _, old = self._graphs.popitem(last=False)
                if self._pending:  # freed once its runs are settled
                    self._evicted.append(old)
        else:
            self._graphs.move_to_end(gkey)
            st.x.copy_(op.x)
        g.graph.replay()
        self.replay_count += 1
        # the next replay of this program may overwrite it: copy out now
        return st.out.clone()

    def run_op(self, op) -> torch.Tensor:
        """Run one coded op end to end; return the decoded (k,)+piece-shape
        stack.  On the card the run is issued and not waited for: the
        returned stack is read in stream order by whatever follows, and
        the run's ``RunReport`` (``wall_s`` == ``t_complete``: its time on
        the card, from a pair of timing events around the replay) is
        delivered at the next ``settle`` or ``last_report``.  A CPU
        program has finished when it returns: its report is booked at once
        with the host's wall, and the span after it is summed into
        ``wait_s``.  Spans: ``repro.mesh.replay`` (the program's run: a
        graph replay on the card, ``repro.mesh.capture`` inside it when the
        graph is new) and ``repro.mesh.sync`` (the record of the run's end
        event)."""
        scheme = op.scheme
        validate_pieces(self.mesh, scheme.n, axis=self.axis)
        subset = self._subset(scheme)
        key = self._key(op, subset)
        if key not in self._programs:
            self._programs.add(key)
            self.compile_count += 1
        cuda = op.x.device.type == "cuda"
        if cuda:
            self._check_stream(op.x.device)
            start, end = self._event(), self._event()
            start.record()
        t0 = time.perf_counter()
        with span("mesh.replay"):
            out = (self._replay(op, subset, key) if cuda
                   else self.program(op, subset, op.x))
        t1 = time.perf_counter()
        with span("mesh.sync"):
            if cuda:
                end.record()
        t2 = time.perf_counter()
        self._count(scheme, subset)
        if cuda:
            self._defer(scheme, subset, start, end)
        else:
            self.wait_s += t2 - t1
            self._book(scheme, subset, t2 - t0)
        return out

    # -- reports of the card's runs ------------------------------------------
    def _check_stream(self, device) -> None:
        """Runs never overlap only because the card runs one stream in
        order: refuse a run issued on another stream than the first's."""
        stream = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = stream
        elif stream != self._stream:
            raise RuntimeError(
                "MeshExecutor: run_op on another CUDA stream than its "
                "earlier runs'; its programs share buffers that only one "
                "stream's order keeps apart")

    def _event(self) -> "torch.cuda.Event":
        return (self._events.pop() if self._events
                else torch.cuda.Event(enable_timing=True))

    def _defer(self, scheme, subset: tuple[int, ...], start, end) -> None:
        """Hold a card run's report until its end event has fired.  The
        run counts in ``queued_runs`` when the run before it had not."""
        if self._pending and not self._pending[-1].end.query():
            self.queued_runs += 1
        self._pending.append(_Pending(scheme, subset, self._chain_t,
                                      start, end))
        if len(self._pending) >= MAX_PENDING:
            self.settle()

    def settle(self) -> None:
        """Deliver every pending report, in run order, each once, to
        ``last_report``, the trace sink and ``on_report``.  Called after a
        copy to the host, which has waited for every run before it, this
        never waits; otherwise it waits for the last run on the card and
        sums the wait into ``wait_s``."""
        if not self._pending:
            return
        last = self._pending[-1].end
        if not last.query():
            t0 = time.perf_counter()
            last.synchronize()
            self.wait_s += time.perf_counter() - t0
        # swapped out first: a report's reader (``last_report`` in an
        # ``on_report`` hook) finds nothing left to book
        pending, self._pending = self._pending, collections.deque()
        for p in pending:
            wall = p.start.elapsed_time(p.end) / 1e3
            self._events += (p.start, p.end)
            self._book(p.scheme, p.subset, wall, p.t_submit)
        if not self._pending:
            self._evicted.clear()

    def _count(self, scheme, subset: tuple[int, ...]) -> None:
        dead = {p for p in self.dead if p < scheme.n}
        self.pool.dispatch_count += scheme.n + sum(
            1 for p in dead if p in subset)
        self.run_count += 1

    def _book(self, scheme, subset: tuple[int, ...], wall: float,
              t_submit: float | None = None) -> None:
        n = scheme.n
        t_submit = self._chain_t if t_submit is None else t_submit
        dead = {p for p in self.dead if p < n}
        report = RunReport(
            t_complete=wall, wall_s=wall, subset=list(subset),
            arrivals=[Arrival(worker=p, piece=p, t=wall) for p in subset],
            failures=[(p, 0.0) for p in sorted(dead)],
            redispatched=[(p, p, p) for p in sorted(dead) if p in subset],
            cancelled=[p for p in range(n)
                       if p not in subset and p not in dead],
            assignment={p: p for p in range(n)},
            t_submit=t_submit)
        self._last_report = report
        if self.trace_sink is not None:
            from ..telemetry.trace import Span
            origin = float(getattr(self.trace_sink, "origin", 0.0))
            self.trace_sink.span(Span(
                "run", "exec", origin + t_submit, wall, "mesh",
                {"n": n, "k": scheme.k, "pieces": len(report.assignment),
                 "redispatches": len(report.redispatched),
                 "decoded": len(report.subset)}))
        if self.on_report is not None:
            self.on_report(report)
