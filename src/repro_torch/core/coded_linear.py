"""Coded distributed GEMM — the transformer adaptation of CoCoI.

The paper codes 2D convolution because it is linear in its input.  A GEMM
``Y = X @ W`` is the degenerate K=S=1 case: the token dimension plays the
role of the output width, partitions are disjoint (no halo), and the same
(n, k)-MDS encode/decode applies row-exactly:

    G (X_1..X_k) @ W  =  (G X)_1..n @ W      (linearity in X)

This is what lets CoCoI act on the type-1 ops of transformer
architectures (FFN and projection GEMMs).  Nonlinear ops (softmax
attention, SSM selective scan, activations) remain uncoded type-2 work,
mirroring the paper's type-1/type-2 split.

The functional form's n worker GEMMs and the master's remainder rows are
plain ``torch.matmul`` products, as the reference leaves them to its
compiler; on the worker pool (``executor=``) each piece GEMM runs the
skinny-GEMM kernel (dist/executor.py), and so does each rank's piece in
the sharded form (``coded_matmul_sharded``, one piece per rank of a
``torch.distributed`` mesh axis).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..kernels.skinny_gemm import skinny_gemm
from ..telemetry.trace import span
from .coded_conv import _count_op, gather_pieces, piece_rank
from .coding import device_index
from .schemes import (CodingScheme, commutes_elementwise, resolve_subset,
                      source_of_piece)
from .splitting import SplitPlan, plan_token_split

__all__ = ["coded_matmul", "coded_matmul_sharded", "coded_ffn_segment"]


def _encode_tokens(code: CodingScheme, x: torch.Tensor, plan: SplitPlan
                   ) -> torch.Tensor:
    """(T, d) tokens -> (n, T_p, d) coded token slices."""
    k = code.k
    t_p = plan.w_out_p
    parts = x[: k * t_p].reshape(k, t_p, -1)
    flat = parts.reshape(k, -1)
    return code.encode(flat).reshape(code.n, t_p, x.shape[-1])


def coded_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    code: CodingScheme,
    subset: Sequence[int] | None = None,
    executor=None,
    assignment: Sequence[int] | None = None,
) -> torch.Tensor:
    """Exact Y = X @ W recovered from a decodable subset of the n coded
    worker GEMMs, under any registered scheme.

    x: (T, d_in), w: (d_in, d_out).  The remainder rows (T mod k) are
    computed by the master (paper footnote 2).  ``w`` may be the model's
    source weight in another type than ``x`` (bf16 parameters): it is cast
    to ``x``'s type where the pieces run — inside the backend's op on an
    executor, here for the functional form and the master's remainder.

    With ``executor`` (a ``repro_torch.dist.CodedExecutor``) the n GEMM
    subtasks run on the worker pool and the decode consumes the first
    decodable arrivals; ``subset`` is ignored, ``assignment`` optionally
    routes per-worker piece counts (``hetero.allocate_pieces``).

    The call is one ``repro.coded.matmul`` span.
    """
    with span("coded.matmul"):
        T = x.shape[0]
        plan = plan_token_split(T, code.k)
        if executor is not None and hasattr(executor, "run_op"):
            # backend seam (dist/backend.py): hand the backend the whole
            # op — source stack + weights — so encode / piece GEMM / decode
            # run where the backend wants them
            from ..dist.backend import CodedOp

            parts = x[: code.k * plan.w_out_p].reshape(code.k,
                                                       plan.w_out_p, -1)
            _count_op("encode")
            decoded = executor.run_op(
                CodedOp("matmul", code, parts, w, assignment=assignment))
            y = decoded.reshape(code.k * plan.w_out_p, w.shape[-1])
            _count_op("decode")
            if plan.remainder is not None:
                y = torch.cat([y, x[plan.remainder.a_i :] @ w.to(x.dtype)],
                              dim=0)
            return y
        w = w.to(x.dtype)
        coded_in = _encode_tokens(code, x, plan)  # (n, T_p, d_in)
        _count_op("encode")
        if executor is not None:
            # legacy thunk surface: pre-seam executors and test doubles
            decoded = executor.run(
                code,
                [lambda i=i: coded_in[i] @ w for i in range(code.n)],
                assignment=assignment,
            )  # (k, T_p, d_out)
            y = decoded.reshape(code.k * plan.w_out_p, w.shape[-1])
        else:
            subset = resolve_subset(code, subset)
            coded_out = torch.matmul(coded_in, w)  # n worker GEMMs
            sel = coded_out.index_select(
                0, device_index(subset, coded_out.device))
            decoded = code.decode_from(subset, sel.reshape(len(subset), -1))
            y = decoded.reshape(code.k * plan.w_out_p, w.shape[-1])
        _count_op("decode")
        if plan.remainder is not None:
            y = torch.cat([y, x[plan.remainder.a_i :] @ w], dim=0)
        return y


def coded_matmul_sharded(
    x: torch.Tensor,
    w: torch.Tensor,
    code: CodingScheme,
    mesh,
    axis: str = "model",
) -> torch.Tensor:
    """Pod form: n coded GEMM subtasks on the ``axis`` mesh axis.

    SPMD over a ``torch.distributed`` ``DeviceMesh``: every rank holds x
    and w, splits and encodes the tokens as :func:`coded_matmul` does (the
    coding GEMM kernel), runs the piece of its coordinate on ``axis``
    through the skinny-GEMM kernel's piece regime, all-gathers the n pieces
    over ``axis``, decodes ``code.default_subset()`` and appends the
    master's remainder rows (T mod k).  Every rank returns the same bits.
    """
    rank, group = piece_rank(mesh, axis, code)
    plan = plan_token_split(x.shape[0], code.k)
    w = w.to(x.dtype)
    coded_in = _encode_tokens(code, x, plan)  # (n, T_p, d_in)
    _count_op("encode")
    coded_out = gather_pieces(skinny_gemm(coded_in[rank], w), group)
    subset = code.default_subset()
    sel = coded_out.index_select(0, device_index(subset, coded_out.device))
    decoded = code.decode_from(subset, sel.reshape(len(subset), -1))
    y = decoded.reshape(code.k * plan.w_out_p, w.shape[-1])
    _count_op("decode")
    if plan.remainder is not None:
        y = torch.cat([y, x[plan.remainder.a_i :] @ w], dim=0)
    return y


def coded_ffn_segment(
    x: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor],
    code: CodingScheme,
    w_gate: torch.Tensor | None = None,
    subset: Sequence[int] | None = None,
    executor=None,
    assignment: Sequence[int] | None = None,
) -> torch.Tensor:
    """The whole (gated) FFN as ONE coded token segment.

    Token slices are the K=S=1 degenerate width split: no halo at all, so
    consecutive GEMMs keep their slice resident trivially — the only
    obstacle to fusing in -> act -> (gate *) -> out into a single
    encode/decode pair is the activation, which commutes exactly with
    selection-structured schemes (replication/uncoded).  For those the
    coded-GEMM boundary count of one FFN drops from 6 (3 per-GEMM
    encode/decode pairs) to 2, and the master<->worker traffic from
    3 x (d_model + d_ff)-sized transfers to one d_model each way.  Linear
    mixes (MDS/LT) are rejected: relu(G x) != G relu(x).

    x: (T, d_model).  The T mod k remainder tokens run on the master
    through the same fused chain (footnote 2).
    """
    if not commutes_elementwise(code):
        raise ValueError(
            f"scheme {getattr(code, 'scheme_name', code)} is a linear mix: "
            "the FFN activation cannot run inside a coded token slice — "
            "use per-GEMM coded_matmul (decode before each activation)")
    T = x.shape[0]
    plan = plan_token_split(T, code.k)
    # source weights (bf16 parameters) are cast to x's type here, once
    w_in, w_out = w_in.to(x.dtype), w_out.to(x.dtype)
    if w_gate is not None:
        w_gate = w_gate.to(x.dtype)

    def chain(xt: torch.Tensor) -> torch.Tensor:
        h = xt @ w_in
        h = act(xt @ w_gate) * h if w_gate is not None else act(h)
        return h @ w_out

    t_p = plan.w_out_p
    srcs = [source_of_piece(code, i) for i in range(code.n)]
    piece_in = [x[s * t_p:(s + 1) * t_p] for s in srcs]
    _count_op("encode")  # the selection dispatch is the boundary op
    if executor is not None:
        decoded = executor.run(
            code, [lambda i=i: chain(piece_in[i]) for i in range(code.n)],
            assignment=assignment)
        y = decoded.reshape(code.k * t_p, w_out.shape[-1])
    else:
        subset = resolve_subset(code, subset)
        outs = torch.stack([chain(piece_in[i]) for i in subset])
        decoded = code.decode_from(subset, outs.reshape(len(subset), -1))
        y = decoded.reshape(code.k * t_p, w_out.shape[-1])
    _count_op("decode")
    if plan.remainder is not None:
        y = torch.cat([y, chain(x[plan.remainder.a_i:])], dim=0)
    return y
