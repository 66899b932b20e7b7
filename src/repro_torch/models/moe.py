"""A dropless, expert-parallel mixture of experts: the layer holds a
contiguous share of the experts, routes each token over all of them, and
computes the part of the result its own experts give.

    logits = u @ router                      (Tt, E) f32, E the published experts
    (v, e) = top_k(logits);  g = softmax(v)  over the k picked
    routed(u) = sum over j with e_j held:  g_j * W2[e_j] (SiLU(u W1g[e_j]) * u W1u[e_j])

The gates are not renormalised over the held experts: the devices that
hold the others add their slots.  No slot is dropped: every slot routed to
a held expert is computed.  The slots are sorted by expert (a stable sort,
the slots of experts held elsewhere last) and cut by offsets, the experts'
three projections run as grouped GEMMs over the held experts
(``kernels/grouped_gemm.py``: one launch a projection, the tokens gathered
as they are loaded, the down projection scaling each row by its gate and
writing it back in slot order), and each token sums its k slots in f32 in
slot order, which is deterministic on the card.  Every shape is known
before the data: only the offsets, which the kernel reads on the card, are
data, so the layer never waits on the card.

The three projections' buffers have a row for each of the Tt * k slots,
as the shapes must be known before the routing is: only the rows of held
experts are computed, and the down projection's output starts at zero so
that the slots of experts held elsewhere add nothing.

The layer runs in a ``repro.model.moe`` span (the model's), split into
``repro.moe.route``, ``repro.moe.experts`` and ``repro.moe.combine``.  The
counters (:class:`MoECounters`) are always on: a serving engine installs
its own with :func:`counting`; the slots routed to held experts, the rows
the down projection's launches covered (counted by the kernel) and the
largest group accumulate on the card and are read by
:meth:`MoECounters.read`.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..kernels.grouped_gemm import grouped_gemm
from ..telemetry.trace import span

__all__ = ["MoECounters", "counting", "route", "dropless_moe"]

_TLS = threading.local()


class MoECounters:
    """Cumulative counts of the mixture-of-experts layers a serving engine
    ran: ``calls`` (layer calls) and ``tokens`` (their tokens) on the host;
    on the card ``rows`` (the rows the held experts computed: for the
    dropless layer, the rows its down projection's launches covered, as
    the kernel counts them), ``max_group`` (the most rows one held expert
    got in one call) and ``dropped`` (routed slots left uncomputed: the
    capacity layer's drops, and the dropless layer's slots routed to a held
    expert that no launch covered, which must be 0).

    ``offsets``: None, or a list to which each dropless layer call appends
    its held experts' row offsets (left on the card), for a reader of the
    grouped GEMM's group sizes."""

    def __init__(self):
        self.calls = 0
        self.tokens = 0
        self.offsets = None
        self._dev: dict = {}

    def _acc(self, name: str, value: torch.Tensor, op: str = "add"):
        cur = self._dev.get(name)
        value = value.detach().to(torch.int64)
        if cur is None:
            self._dev[name] = value.clone()
        elif op == "max":
            torch.maximum(cur, value, out=cur)
        else:
            cur.add_(value)

    def covered(self, device) -> torch.Tensor:
        """The card's count of the rows the dropless layer's launches
        covered, which the grouped GEMM adds to (``done``)."""
        cur = self._dev.get("covered")
        if cur is None:
            cur = self._dev["covered"] = torch.zeros((), dtype=torch.int64,
                                                     device=device)
        return cur

    def count(self, tokens: int, rows=None, max_group=None, dropped=None,
              routed=None):
        """One layer call: the capacity layer gives ``rows`` and
        ``dropped``; the dropless layer gives ``routed``, its slots routed
        to held experts, and its launches count what they covered."""
        self.calls += 1
        self.tokens += int(tokens)
        for name, v, op in (("rows", rows, "add"),
                            ("max_group", max_group, "max"),
                            ("dropped", dropped, "add"),
                            ("routed", routed, "add")):
            if v is not None:
                self._acc(name, v, op)

    def read(self) -> dict:
        """The counts as plain numbers (one copy from the card each)."""
        v = {k: int(t) for k, t in self._dev.items()}
        covered = v.get("covered", 0)
        return {"calls": self.calls, "tokens": self.tokens,
                "rows": v.get("rows", 0) + covered,
                "max_group": v.get("max_group", 0),
                "dropped": v.get("dropped", 0) + v.get("routed", 0) - covered}


@contextlib.contextmanager
def counting(counters: MoECounters | None):
    """Count this thread's mixture-of-experts layers into ``counters``."""
    prev = getattr(_TLS, "counters", None)
    _TLS.counters = counters
    try:
        yield counters
    finally:
        _TLS.counters = prev


def current_counters() -> MoECounters | None:
    return getattr(_TLS, "counters", None)


def route(router: torch.Tensor, flat: torch.Tensor, top_k: int, first: int,
          held: int):
    """Top-``top_k`` routing of ``flat`` (Tt, D) over ``router``'s E
    experts, of which experts ``first`` .. ``first + held - 1`` are held.

    Returns ``(gates (Tt*k,) f32, is_held (Tt*k,), order (Tt*k,) int32,
    offsets (held + 1,) int32, counts (held + 1,) int64)``: each slot's
    gate and whether its expert is held, the slots sorted by held expert
    (the others last, each group in slot order), the held experts' row
    offsets into that order, and the rows of each held expert followed by
    the slots held elsewhere."""
    logits = flat.float() @ router.float()                   # (Tt, E)
    top, eid = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(top, dim=-1).reshape(-1)
    local = eid.reshape(-1) - first
    is_held = (local >= 0) & (local < held)
    key = torch.where(is_held, local, torch.full_like(local, held))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=held + 1)
    offsets = torch.zeros(held + 1, dtype=torch.int32, device=flat.device)
    offsets[1:] = torch.cumsum(counts[:held], 0)
    return gates, is_held, order.to(torch.int32), offsets, counts


def dropless_moe(p: dict, x: torch.Tensor, top_k: int, first: int = 0
                 ) -> torch.Tensor:
    """The held experts' part of the routed FFN of ``x`` (B, T, D): ``p``
    holds ``router`` (D, E) f32 and the held experts' ``w_gate``, ``w_in``
    (H, D, F) and ``w_out`` (H, F, D), experts ``first`` .. ``first + H -
    1``.  Returns (B, T, D) f32."""
    Bsz, T, D = x.shape
    held = p["w_in"].shape[0]
    flat = x.reshape(-1, D)
    Tt = flat.shape[0]
    with span("moe.route"):
        gates, is_held, order, offsets, counts = route(
            p["router"], flat, top_k, first, held)
        token = torch.div(order, top_k, rounding_mode="floor")
        scale = torch.where(is_held, gates, torch.zeros_like(gates))[order]
    counters = current_counters()
    with span("moe.experts"):
        g = grouped_gemm(flat, p["w_gate"], offsets, rows=token)
        h = grouped_gemm(flat, p["w_in"], offsets, rows=token)
        a = F.silu(g) * h
        # every slot's row: those of experts held elsewhere stay 0
        ys = grouped_gemm(a, p["w_out"], offsets, scale=scale, dst=order,
                          out=torch.zeros((Tt * top_k, D), dtype=x.dtype,
                                          device=x.device),
                          done=None if counters is None
                          else counters.covered(x.device))
    with span("moe.combine"):
        out = torch.sum(ys.view(Tt, top_k, D), dim=1, dtype=torch.float32)
    if counters is not None:
        counters.count(Tt, routed=offsets[held],
                       max_group=counts[:held].max())
        if counters.offsets is not None:
            counters.offsets.append(offsets)
    return out.view(Bsz, T, D)
