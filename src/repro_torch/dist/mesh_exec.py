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
``shard_map`` program.  A run then costs one graph launch and one stream
synchronise, where the threaded backend makes n + 2 launches from n + 1
threads and a synchronise per piece.  On a CPU tensor the same program runs
eagerly on the kernels' plain versions.

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
from .clock import RealClock
from .executor import decodable_prefix
from .pool import Arrival, RunReport, Undecodable

__all__ = ["MeshExecutor"]

# CUDA graphs one executor keeps, least recently replayed dropped first:
# served Zamba2-1.2B needs 9 (three token counts x three FFN weights)
MAX_GRAPHS = 64


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
class _Graph:
    """One captured program: replay after copying the op's sources into
    ``x``; ``out`` holds the decoded stack until the next replay of any
    graph of the executor (they share one memory pool)."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    out: torch.Tensor
    # kept alive while the graph may replay: the weight whose pointer the
    # graph baked in, and the device copies of the coding matrices and
    # gather indices it reads (core/coding.py may drop its cache)
    w: torch.Tensor
    held: list


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
    ``replay_count`` replays.
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
        self.last_report: RunReport | None = None
        self.on_report = None
        # optional telemetry.TraceSink.  One program has no per-piece
        # timeline — the mesh emits run-level spans ONLY, on real wall time
        self.trace_sink = None
        self.compile_count = 0
        self.graph_count = 0
        self.replay_count = 0
        self._programs: set = set()
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool_handle = None
        self._chain_t = 0.0

    # -- executor contract (dist/backend.py) --------------------------------
    def close(self) -> None:
        self._programs.clear()
        self._graphs.clear()

    def __enter__(self) -> "MeshExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @contextlib.contextmanager
    def chain(self, start: float = 0.0):
        """Causal-chain marker for API parity: runs are synchronous, so
        successive run_ops are already serial; nothing to gate."""
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
        """The op's program, eagerly: encode (the threaded ``run_op``'s
        call), every piece in one launch, gather ``subset``, decode.  The
        reference multiplies the pieces by a 0/1 lane mask before its
        gather; ``x * 1.0`` changes no bit and the gather never reads a
        masked lane, so the mask is left out."""
        from ..core.coded_conv import _encode_partitions
        from ..core.coding import device_index
        from ..kernels.conv2d import conv2d_stacked
        from ..kernels.skinny_gemm import piece_gemm_stacked

        scheme = op.scheme
        if op.kind == "matmul":
            k, t_p, d = x.shape
            coded = scheme.encode(x.reshape(k, -1)).reshape(scheme.n, t_p, d)
            pieces = piece_gemm_stacked(coded, op.w)
        else:
            coded = _encode_partitions(scheme, x)
            pieces = conv2d_stacked(coded, op.w, op.spec.stride)
        gathered = pieces.index_select(0, device_index(subset, pieces.device))
        return decode_blocks(scheme, list(subset), gathered)

    def _key(self, op, subset: tuple[int, ...]) -> tuple:
        stride = op.spec.stride if op.spec is not None else None
        return (op.kind, _scheme_key(op.scheme), tuple(op.x.shape),
                str(op.x.dtype), tuple(op.w.shape), str(op.w.dtype),
                stride, subset)

    def _capture(self, op, subset: tuple[int, ...]) -> _Graph:
        """Run the program eagerly once (it builds the kernels and uploads
        the coding matrices and indices: a host-to-device copy cannot be
        captured), then capture it.  The kernel wrappers count their calls
        in both; a replay calls no wrapper and counts in ``replay_count``
        only (the device's own record of a replay's kernels is the
        profiler's)."""
        from ..core import coding

        x = op.x.contiguous().clone()
        self.program(op, subset, x)
        if self._pool_handle is None:
            self._pool_handle = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool_handle):
                out = self.program(op, subset, x)
        except RuntimeError as e:
            raise RuntimeError(
                f"MeshExecutor: capturing the {op.kind} program as a CUDA "
                f"graph failed ({e}); the mesh backend runs only as a "
                "graph on the card") from e
        return _Graph(graph, x, out, op.w,
                      list(coding._DEVICE_CACHE.values()))

    def _replay(self, op, subset: tuple[int, ...], key: tuple
                ) -> torch.Tensor:
        gkey = key + (op.w.data_ptr(),)
        g = self._graphs.get(gkey)
        if g is None:
            g = self._capture(op, subset)
            self._graphs[gkey] = g
            self.graph_count += 1
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(gkey)
        g.x.copy_(op.x)
        g.graph.replay()
        self.replay_count += 1
        # the next replay of any graph may reuse this memory: copy out now
        return g.out.clone()

    def run_op(self, op) -> torch.Tensor:
        """Run one coded op end to end; return the decoded (k,)+piece-shape
        stack.  ``RunReport.wall_s`` == ``t_complete`` (there is no
        virtual plane) is wall time that ends once the result is on the
        device: one stream synchronise per run."""
        scheme = op.scheme
        validate_pieces(self.mesh, scheme.n, axis=self.axis)
        subset = self._subset(scheme)
        key = self._key(op, subset)
        if key not in self._programs:
            self._programs.add(key)
            self.compile_count += 1
        t0 = time.perf_counter()
        if op.x.device.type == "cuda":
            out = self._replay(op, subset, key)
            torch.cuda.current_stream(op.x.device).synchronize()
        else:
            out = self.program(op, subset, op.x)
        wall = time.perf_counter() - t0
        self._book(scheme, subset, wall)
        return out

    def _book(self, scheme, subset: tuple[int, ...], wall: float) -> None:
        n = scheme.n
        dead = {p for p in self.dead if p < n}
        report = RunReport(
            t_complete=wall, wall_s=wall, subset=list(subset),
            arrivals=[Arrival(worker=p, piece=p, t=wall) for p in subset],
            failures=[(p, 0.0) for p in sorted(dead)],
            redispatched=[(p, p, p) for p in sorted(dead) if p in subset],
            cancelled=[p for p in range(n)
                       if p not in subset and p not in dead],
            assignment={p: p for p in range(n)},
            t_submit=self._chain_t)
        self.pool.dispatch_count += n + sum(1 for p in dead if p in subset)
        self.run_count += 1
        self.last_report = report
        if self.trace_sink is not None:
            from ..telemetry.trace import Span
            origin = float(getattr(self.trace_sink, "origin", 0.0))
            self.trace_sink.span(Span(
                "run", "exec", origin + self._chain_t, wall, "mesh",
                {"n": n, "k": scheme.k, "pieces": len(report.assignment),
                 "redispatches": len(report.redispatched),
                 "decoded": len(report.subset)}))
        if self.on_report is not None:
            self.on_report(report)
