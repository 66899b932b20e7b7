"""Coded distributed 2D convolution (paper §II-B, Fig. 2).

Pipeline for one type-1 layer:

    split (eqs. 1-2)  ->  encode (eq. 3)  ->  n parallel conv subtasks
    ->  any-sufficient-subset decode (eq. 4)  ->  width-concat (+ remainder)

Convolution is linear in its input, so f(G x) = G f(x) row-wise and the
decode recovers the *exact* uncoded output (up to f32 roundoff of the
decode solve) — inference quality is unchanged (§II-B.4).

The pipeline is written against the
:class:`~repro_torch.core.schemes.CodingScheme` protocol: any registered
scheme (MDS, replication, LT, uncoded) slots in — ``encode``/``decode_from``
are the only scheme-specific steps.  MDS and LT route their encode/decode
GEMMs through the skinny-GEMM kernel (kernels/skinny_gemm.py), and
:func:`conv2d` — the one place a convolution happens, for worker pieces,
master remainders and local layers alike — through the direct-conv kernel
(kernels/conv2d.py).  For a CPU tensor both compute their plain PyTorch
versions.

Two execution modes:

* ``coded_conv2d``            — single-host functional form (the n subtasks
                                fold into the batch axis of one conv
                                launch); used by tests / the simulator.
                                Passing ``executor=`` (a
                                ``repro_torch.dist.CodedExecutor``) instead
                                runs the n subtasks on the threaded worker
                                pool and decodes at the k-th *arrival* —
                                stragglers are cancelled, failures
                                re-dispatched.
* ``run_segment``             — a coded multi-layer segment: one encode,
                                per-piece conv chains, one decode.
* ``coded_conv2d_sharded``    — SPMD over a ``torch.distributed`` mesh
                                axis: each rank computes one coded piece
                                (the reference's pod form, DESIGN.md §3).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..kernels.conv2d import conv2d as _conv2d_kernel
from ..telemetry.trace import span
from .coding import device_index
from .schemes import (CodingScheme, chunk_bounds, commutes_elementwise,
                      decode_blocks, resolve_subset, source_of_piece)
from .splitting import (ChainPlan, ConvSpec, SegmentSplitPlan, SplitPlan,
                        plan_segment_split, plan_width_split)

__all__ = [
    "conv2d",
    "conv2d_chunked",
    "split_input",
    "coded_conv2d",
    "coded_conv2d_sharded",
    "run_segment",
    "boundary_op_counter",
    "ACTIVATIONS",
]


# ---------------------------------------------------------------------------
# boundary-op accounting: how many master encode/decode operations ran
# ---------------------------------------------------------------------------
# The netplan claim ("2·segments coding ops instead of 2·L") is enforced by
# tests counting the operations the execution layer ACTUALLY performs, not
# what the plan promises.  Selection schemes' encode/decode are flop-free
# gathers but are still boundary operations (a master round-trip each), so
# they count too.

_OPS_TLS = threading.local()


@contextlib.contextmanager
def boundary_op_counter():
    """Count master-side encode/decode boundary operations in this thread.

    Yields a dict ``{"encode": int, "decode": int}`` updated in place by
    every coded pipeline run (per-layer or segment) entered under the
    context.
    """
    counts = {"encode": 0, "decode": 0}
    prev = getattr(_OPS_TLS, "counts", None)
    _OPS_TLS.counts = counts
    try:
        yield counts
    finally:
        _OPS_TLS.counts = prev


def _count_op(kind: str) -> None:
    counts = getattr(_OPS_TLS, "counts", None)
    if counts is not None:
        counts[kind] += 1


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu is the tanh approximation, not erf
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "gelu": _gelu_tanh,
    "silu": F.silu,
}


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain VALID conv (input is pre-padded, as in the paper). NCHW/OIHW.

    A CUDA tensor goes through the hand-written direct-conv kernel (width
    slices are read in place through their strides); a CPU tensor through
    ``F.conv2d``.
    """
    return _conv2d_kernel(x, w, stride)


def conv2d_chunked(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                   chunks: int = 1) -> torch.Tensor:
    """VALID conv computed in ``chunks`` output-column blocks (streamed
    scatter): block [a, b) consumes input columns
    [a*stride, (b-1)*stride + K_W), so compute on the first shipped entry
    chunk starts while the rest is still in flight.  Output columns are the
    same reductions over the same values as the one-shot conv; only the
    evaluation order is tiled."""
    k_w = w.shape[-1]
    w_out = (x.shape[-1] - k_w) // stride + 1
    c = max(1, min(int(chunks), int(w_out)))
    if c <= 1:
        return conv2d(x, w, stride)
    outs = [conv2d(x[..., a * stride:(b - 1) * stride + k_w], w, stride)
            for a, b in chunk_bounds(w_out, c)]
    return torch.cat(outs, dim=-1)


def split_input(x: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """Stack the k overlapping input partitions: (B,C,H,W_I) -> (k,B,C,H,W_I^p)."""
    return torch.stack([x[..., p.a_i : p.b_i] for p in plan.parts])


def _encode_partitions(code: CodingScheme, parts: torch.Tensor) -> torch.Tensor:
    """(k, B,C,H,Wp) -> (n, B,C,H,Wp) via flatten -> encode -> unflatten (eq. 3)."""
    k = parts.shape[0]
    flat = parts.reshape(k, -1)
    coded = code.encode(flat)
    return coded.reshape((code.n,) + tuple(parts.shape[1:]))


def coded_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    code: CodingScheme,
    spec: ConvSpec,
    subset: Sequence[int] | None = None,
    plan: SplitPlan | None = None,
    executor=None,
    assignment: Sequence[int] | None = None,
) -> torch.Tensor:
    """Full coded pipeline; returns the exact conv output f(x).

    ``code`` is any registered scheme instance (MDS, replication, LT,
    uncoded).  ``subset`` is the index set S of the fastest workers whose
    outputs decoding consumes — the others are stragglers whose results are
    discarded, which we emulate by simply not consuming them.  It may hold
    more than k indices for schemes that need extra symbols (LT); ``None``
    means the scheme's canonical decodable subset.

    With ``executor`` (a ``repro_torch.dist.CodedExecutor``) the subset is
    not chosen up front: the n subtasks run on the worker pool and the
    decode consumes the first decodable *arrivals* (``executor.last_report``
    has the evidence).  ``assignment`` optionally gives per-worker piece
    counts (``hetero.allocate_pieces``); ``subset`` is ignored in this mode.
    """
    if plan is None:
        plan = plan_width_split(spec, code.k)
    parts = split_input(x, plan)  # (k, B, C, H, W_I^p)
    if executor is not None and hasattr(executor, "run_op"):
        # backend seam (dist/backend.py): the backend owns encode ->
        # per-piece conv -> decode
        from ..dist.backend import CodedOp

        _count_op("encode")
        y_parts = executor.run_op(
            CodedOp("conv2d", code, parts, w, spec=spec,
                    assignment=assignment))
        _count_op("decode")
        y = torch.cat(list(y_parts), dim=-1)
        if plan.remainder is not None:
            pr = plan.remainder
            y_rem = conv2d(x[..., pr.a_i : pr.b_i], w, spec.stride)
            y = torch.cat([y, y_rem], dim=-1)
        return y
    coded_in = _encode_partitions(code, parts)  # (n, ...)
    _count_op("encode")

    if executor is not None:
        # legacy thunk surface: pre-seam executors and test doubles
        y_parts = executor.run(
            code,
            [lambda i=i: conv2d(coded_in[i], w, spec.stride)
             for i in range(code.n)],
            assignment=assignment,
        )  # (k, B, C_O, H_O, W_O^p)
    else:
        subset = resolve_subset(code, subset)
        # Execution phase: each worker i computes f(X~_i), same weights.
        # The n pieces fold into the batch axis: one conv launch.
        n, b = coded_in.shape[:2]
        out = conv2d(coded_in.reshape((n * b,) + tuple(coded_in.shape[2:])),
                     w, spec.stride)
        coded_out = out.reshape((n, b) + tuple(out.shape[1:]))

        # Decoding phase: any sufficient subset of outputs decodes (eq. 4).
        sel = coded_out.index_select(0, device_index(subset, coded_out.device))
        flat = sel.reshape(len(subset), -1)
        decoded = code.decode_from(subset, flat)
        y_parts = decoded.reshape((code.k,) + tuple(coded_out.shape[1:]))
    _count_op("decode")

    # Reassemble on the width dim; master-kept remainder (footnote 2).
    y = torch.cat(list(y_parts), dim=-1)
    if plan.remainder is not None:
        r = plan.remainder
        y_rem = conv2d(x[..., r.a_i : r.b_i], w, spec.stride)
        y = torch.cat([y, y_rem], dim=-1)
    return y


def _chain(xp: torch.Tensor, cp: ChainPlan, weights: Sequence[torch.Tensor],
           specs: Sequence[ConvSpec], pads: Sequence[int],
           acts: Sequence[str | None], apply_acts: bool,
           entry_chunks: int = 1) -> torch.Tensor:
    """Run one partition's self-contained conv chain on its (coded or true)
    entry slice.  Interior boundaries re-apply the activation (when
    ``apply_acts``) and inject the re-pad: full zero rows on H, and on W
    only the per-partition edge shortfall (``ChainStep.lz``/``rz``) — the
    interior halo columns are real data already resident in the slice.
    ``entry_chunks > 1`` tiles layer 0's conv over output-column blocks
    (streamed entry: compute starts on the first shipped chunk) — identical
    values, tiled evaluation order."""
    for j, (w, sp) in enumerate(zip(weights, specs)):
        if j > 0:
            st = cp.steps[j]
            if apply_acts and acts[j - 1] is not None:
                xp = ACTIVATIONS[acts[j - 1]](xp)
            p = int(pads[j])
            if p or st.lz or st.rz:
                # F.pad lists the LAST dim first: (W left, W right, H top, H bottom)
                xp = F.pad(xp, (st.lz, st.rz, p, p))
            xp = conv2d(xp, w, sp.stride)
        else:
            xp = conv2d_chunked(xp, w, sp.stride, entry_chunks)
    return xp


def run_segment(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    scheme: CodingScheme,
    specs: Sequence[ConvSpec],
    pads: Sequence[int],
    acts: Sequence[str | None],
    split: SegmentSplitPlan | None = None,
    subset: Sequence[int] | None = None,
    executor=None,
    assignment: Sequence[int] | None = None,
    stream_chunks: int | None = None,
) -> torch.Tensor:
    """Execute a coded *segment*: encode once, per-piece conv chains, decode
    once (core/netplan.py's execution form).

    ``stream_chunks`` (``SegmentStep.chunks`` from the plan compiler)
    streams the scatter/gather in that many column chunks: layer-0 compute
    is tiled per shipped entry chunk and the exit decode runs incrementally
    per column block at the k-th arrival (``schemes.decode_blocks`` — the
    decode-matrix solve is shared, only the skinny GEMM is chunked).  The
    decoded output is identical to the unstreamed run; the virtual-time win
    comes from the delay model's pipelined chunk timeline
    (``dist.SegmentDelay(chunks=...)``).

    ``x`` is the segment's pre-padded entry input (the caller applies layer
    0's pad, exactly as ``coded_conv2d`` expects).  ``acts[j]`` names the
    elementwise activation after layer j; interior activations run inside
    the worker chains — which is only exact for selection-structured
    schemes (``schemes.commutes_elementwise``), so a linear-mix scheme
    with an interior activation or re-pad is rejected loudly rather than
    silently producing wrong output.  The final activation is NOT applied
    here: the master applies it after decode (with any pooling), keeping
    depth-1 segments numerically identical to ``coded_conv2d``.

    Functional form computes the chains of the decoding subset; with
    ``executor`` (a ``repro_torch.dist.CodedExecutor``) each chain is one
    multi-layer piece on the worker pool, decoded at the k-th *arrival*
    with straggler cancellation at segment granularity.

    Spans: ``repro.coded.segment`` around the run, and in it
    ``repro.coded.encode``, ``repro.coded.decode`` and
    ``repro.coded.assemble`` (the width concat and the master's
    remainder).
    """
    d = len(specs)
    if not (len(weights) == len(pads) == len(acts) == d):
        raise ValueError(f"inconsistent segment arity: {len(weights)} weights"
                         f", {d} specs, {len(pads)} pads, {len(acts)} acts")
    if split is None:
        split = plan_segment_split(specs, pads, scheme.k)
    if split.k != scheme.k:
        raise ValueError(f"split.k={split.k} != scheme.k={scheme.k}")
    commuting = commutes_elementwise(scheme)
    if not commuting and d > 1:
        if any(a is not None for a in acts[:-1]):
            raise ValueError(
                f"scheme {getattr(scheme, 'scheme_name', scheme)} is a "
                "linear mix: relu(G x) != G relu(x), so pieces cannot stay "
                "resident across an interior activation — recompile with a "
                "decode point there (netplan places it automatically)")
        if any(int(p) != 0 for p in pads[1:]) or not split.uniform:
            raise ValueError(
                "interior re-padding injects partition-dependent edge zeros"
                " that a linear mix cannot represent piece-locally — only "
                "selection schemes (replication/uncoded) may fuse across it")

    with span("coded.segment"):
        with span("coded.encode"):
            if commuting:
                # selection dispatch: piece i carries its source
                # partition's slice verbatim (edge chains are narrower —
                # no row-stacking involved)
                srcs = [source_of_piece(scheme, i) for i in range(scheme.n)]
                piece_part = [split.parts[s] for s in srcs]
                piece_in = [x[..., cp.entry.a_i:cp.entry.b_i]
                            for cp in piece_part]
            else:
                parts = torch.stack(
                    [x[..., cp.entry.a_i:cp.entry.b_i] for cp in split.parts])
                coded_in = _encode_partitions(scheme, parts)
                piece_part = [split.parts[0]] * scheme.n
                piece_in = [coded_in[i] for i in range(scheme.n)]
        _count_op("encode")
        chunks = max(1, int(stream_chunks)) if stream_chunks else 1

        def _piece(i: int) -> torch.Tensor:
            return _chain(piece_in[i], piece_part[i], weights, specs, pads,
                          acts, apply_acts=commuting, entry_chunks=chunks)

        if executor is not None:
            if hasattr(executor, "ensure_armed"):
                # per-layer telemetry: a depth-d chain piece reports d stage
                # durations; declaring the per-layer sizes lets an adaptive
                # executor feed each stage to the estimator
                from .netplan import segment_layer_sizes

                executor.ensure_armed(segment_layer_sizes(specs, pads, scheme,
                                                          split))
            # the executor decodes at the k-th arrival, in its own
            # coded.decode span
            y_parts = executor.run(
                scheme, [lambda i=i: _piece(i) for i in range(scheme.n)],
                assignment=assignment, decode_chunks=chunks,
            )  # (k, B, C_O, H_O, W_O^p)
        else:
            subset = resolve_subset(scheme, subset)
            outs = torch.stack([_piece(i) for i in subset])
            with span("coded.decode"):
                y_parts = decode_blocks(scheme, subset, outs, chunks=chunks)
        _count_op("decode")

        with span("coded.assemble"):
            y = torch.cat(list(y_parts), dim=-1)
            if split.remainder is not None:
                # footnote 2 at segment granularity: the master runs the
                # remainder columns' whole chain locally, on true values
                # (acts always apply)
                rem = split.remainder
                y_rem = _chain(x[..., rem.entry.a_i:rem.entry.b_i], rem,
                               weights, specs, pads, acts, apply_acts=True)
                y = torch.cat([y, y_rem], dim=-1)
        return y


# ---------------------------------------------------------------------------
# the sharded (SPMD) form: one coded piece per rank of a mesh axis
# ---------------------------------------------------------------------------

def piece_rank(mesh, axis: str, code: CodingScheme) -> tuple[int, object]:
    """``(this rank's coordinate on axis, the axis' process group)`` of a
    ``DeviceMesh`` whose ``axis`` holds one coded piece per rank; raises the
    reference's ``ValueError`` when its extent is not ``code.n``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {names})")
    n = mesh.size(names.index(axis))
    if n != code.n:
        raise ValueError(f"mesh axis {axis} has size {n}, code.n={code.n}")
    return mesh.get_local_rank(axis), mesh.get_group(axis)


def gather_pieces(piece: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``piece`` of ``group``, stacked in rank order: (n,) +
    piece.shape, on ``piece``'s device.  One all-gather
    (``all_gather_into_tensor``) of the contiguous piece, on its own
    device: gloo gathers CUDA tensors too (through host memory, inside the
    collective), which the card's ranks use, since they share one device
    and NCCL takes one rank a device."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = piece.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + tuple(src.shape))


def coded_conv2d_sharded(
    x: torch.Tensor,
    w: torch.Tensor,
    code: CodingScheme,
    spec: ConvSpec,
    mesh,
    axis: str = "model",
) -> torch.Tensor:
    """Pod form: the n coded subtasks live on the ``axis`` mesh axis.

    SPMD over a ``torch.distributed`` ``DeviceMesh``: every rank holds x
    and w, splits and encodes as :func:`coded_conv2d` does (the coding GEMM
    kernel), runs the piece of its coordinate on ``axis`` through the conv
    kernel, all-gathers the n pieces over ``axis`` (:func:`gather_pieces`),
    decodes the scheme's canonical subset and appends the master's
    remainder columns.  Inside one SPMD program all n results exist, so the
    decode takes ``code.default_subset()`` — the output is the one a
    fastest-k gather decodes, and every rank returns the same bits.
    """
    rank, group = piece_rank(mesh, axis, code)
    plan = plan_width_split(spec, code.k)
    coded_in = _encode_partitions(code, split_input(x, plan))  # (n, ...)
    _count_op("encode")
    coded_out = gather_pieces(conv2d(coded_in[rank], w, spec.stride), group)
    subset = code.default_subset()
    sel = coded_out.index_select(0, device_index(subset, coded_out.device))
    decoded = code.decode_from(subset, sel.reshape(len(subset), -1))
    y_parts = decoded.reshape((code.k,) + tuple(coded_out.shape[1:]))
    _count_op("decode")
    y = torch.cat(list(y_parts), dim=-1)
    if plan.remainder is not None:
        r = plan.remainder
        y = torch.cat([y, conv2d(x[..., r.a_i : r.b_i], w, spec.stride)],
                      dim=-1)
    return y
