# Execution-backend seam: the contract the coded call sites rely on.
#
# ``coded_matmul`` / ``coded_conv2d`` (core/) never cared that pieces ran on
# threads — they need a *plan* (how many pieces, which worker gets which), a
# way to *run* one coded op to its decoded output, and a *report sink*
# (``on_report`` / ``last_report`` / ``run_count``) for telemetry.  This
# module names that contract so a second implementation can slot in behind
# one constructor argument.
#
# Backends:
#   * ``dist.executor.CodedExecutor``: the threaded backend.  Real k-of-n
#     semantics — the master returns at the k-th arrival and cancels
#     stragglers.
#   * ``dist.mesh_exec.MeshExecutor``: one device program per op (all n
#     pieces in one launch, a CUDA graph on the card).  k-of-n is
#     algebraic: every piece is computed, the decodable subset is chosen
#     ahead of dispatch from a configured fault pattern.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Protocol, Sequence, runtime_checkable

import torch

from ..core.splitting import ConvSpec

__all__ = ["CodedOp", "ExecBackend", "run_coded_op"]


@dataclass(frozen=True)
class CodedOp:
    """One coded operator, backend-agnostically described.

    ``kind`` selects the math:
      * ``"matmul"``: ``x`` is the stacked per-source token blocks with
        shape (k, t_p, d_in) and ``w`` is (d_in, d_out); piece i computes
        ``encode(x)[i] @ w``.
      * ``"conv2d"``: ``x`` is the stacked per-source width partitions
        (k, N, C, H, W_p) (halos already included) and ``w`` is OIHW;
        piece i computes ``conv2d(encode(x)[i], w, spec.stride)``.

    The decoded result a backend must return is the (k,) + piece-shape
    stack of recovered source outputs — exactly what
    ``core.schemes.decode_blocks`` yields from the first decodable subset.
    """

    kind: str
    scheme: Any
    x: torch.Tensor
    w: torch.Tensor
    spec: ConvSpec | None = None
    assignment: Mapping[int, int] | Sequence[int] | None = None
    decode_chunks: int = 1

    def __post_init__(self) -> None:
        if self.kind not in ("matmul", "conv2d"):
            raise ValueError(f"unknown CodedOp kind: {self.kind!r}")
        if self.kind == "conv2d" and self.spec is None:
            raise ValueError("conv2d CodedOp requires a ConvSpec")


@runtime_checkable
class ExecBackend(Protocol):
    """What a coded-dispatch backend must provide.

    Attributes (telemetry surface):
      * ``run_count``: decoded runs completed so far.
      * ``last_report``: the most recent ``RunReport`` (or ``None``).
      * ``on_report``: optional callback fired with each ``RunReport``.

    Structural extras callers lean on — a ``pool`` facade with ``clock`` /
    ``delay_model`` / ``fault_plan`` / ``dispatch_count`` /
    ``alive_workers()`` / ``group()``, and a ``chain()`` context manager —
    are part of the de-facto contract.
    """

    run_count: int
    last_report: Any
    on_report: Any

    def run_op(self, op: CodedOp) -> torch.Tensor:
        """Encode, dispatch, and decode one coded op; return the (k,)-stack."""
        ...

    def plan_matmul(
        self, scheme: Any, scheme_name: str, n_tokens: int, d_in: int, d_out: int
    ) -> tuple[int | None, int | None, Any]:
        """Optionally re-plan (n, k, assignment) for an upcoming GEMM."""
        ...

    def ensure_armed(self, sizes: Sequence[int]) -> None:
        """Hint the per-segment piece sizes of an upcoming chained run."""
        ...

    def close(self) -> None: ...


def run_coded_op(executor: Any, op: CodedOp) -> torch.Tensor:
    """Dispatch ``op`` on ``executor`` via the backend seam.

    Prefers ``run_op`` (the ``ExecBackend`` protocol); falls back to the
    legacy thunk-list ``run(scheme, fns, ...)`` surface so hand-rolled
    test doubles predating the seam keep working.
    """
    run_op = getattr(executor, "run_op", None)
    if run_op is not None:
        return run_op(op)
    from ..core import coded_conv  # lazy: avoid import cycle

    if op.kind == "matmul":
        coded_in = op.scheme.encode(op.x.reshape(op.x.shape[0], -1)).reshape(
            op.scheme.n, op.x.shape[1], op.x.shape[2]
        )
        fns = [lambda i=i: coded_in[i] @ op.w for i in range(op.scheme.n)]
    else:
        coded_in = coded_conv._encode_partitions(op.scheme, op.x)
        fns = [
            lambda i=i: coded_conv.conv2d(coded_in[i], op.w, op.spec.stride)
            for i in range(op.scheme.n)
        ]
    return executor.run(
        op.scheme, fns, assignment=op.assignment, decode_chunks=op.decode_chunks
    )
