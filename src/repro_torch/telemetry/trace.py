"""Structured span traces of coded-inference runs.

A copy of the reference's ``src/repro/telemetry/trace.py`` (same names,
same output bytes), kept here because the port imports nothing of
``repro``.  The execution layers emit :class:`Span` events into any object
satisfying the :class:`TraceSink` protocol: ``WorkerPool`` emits piece and
phase spans as each run's master loop resolves, and ``CodedExecutor``
emits run spans.  Emission is strictly opt-in: every site guards on
``trace_sink is not None``, so an unset sink costs one attribute load.

Spans carry **virtual** times only (the deterministic plane): a seeded
``FakeClock`` workload exports byte-identical traces across runs, which
is what the golden-file tests pin.

Placement: pool runs report times relative to their *group* timeline.
The emitting layers add the sink's ``origin`` attribute (0.0 when
absent) to every timestamp, so a caller that moves ``origin`` to each
model call's start gets one globally ordered trace.

Exporters:

* :func:`to_jsonl` — one JSON object per span, key-sorted: the replay /
  diff format (byte-stable on the virtual clock);
* :func:`to_chrome_trace` — Chrome-trace / Perfetto JSON ("traceEvents"
  with complete ``ph="X"`` events, microsecond timestamps, one named
  thread per worker), loadable in ``chrome://tracing`` or ui.perfetto.dev.

Beside the virtual plane, :func:`span` marks the port's stages on the
real clock: while a torch profiler records, each is a
``record_function("repro.<name>")`` range in the profiler's own trace, on
the clock and thread of the kernels and ops it holds; otherwise it costs
one flag read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Iterable, Protocol, runtime_checkable

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "span",
    "Span",
    "TraceSink",
    "TraceRecorder",
    "to_jsonl",
    "to_chrome_trace",
]


_OFF = contextlib.nullcontext()


def span(name: str):
    """A live span ``repro.<name>`` of the program, for ``with``.

    While a torch profiler records (the profiler's process-wide flag, set
    by ``torch.profiler.profile`` on whichever thread started it), this
    opens ``torch.profiler.record_function("repro." + name)``: the span
    then lies in the same trace as the ops and kernels it holds, on the
    same clock and thread.  A thread the profiler does not follow (a
    worker thread under a profiler that records its own thread only)
    records nothing.  Otherwise it returns one shared no-op context:
    nothing is built and ``record_function`` is not called.
    """
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function("repro." + name)
    return _OFF


@dataclasses.dataclass(frozen=True)
class Span:
    """One complete interval on one track.

    ``name`` is the granularity ("piece" | "phase" | "run" | "step"),
    ``cat`` the emitting layer ("pool" | "exec" | "serve"), ``t0``/``dur``
    the absolute start and duration in (virtual) seconds, ``tid`` the
    track ("worker-3", "pool", "scheduler"), and ``args`` free-form
    telemetry (piece ids, run piece counts, step counters) that the
    exporters serialize key-sorted.
    """

    name: str
    cat: str
    t0: float
    dur: float
    tid: str
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "t0": self.t0,
                "dur": self.dur, "tid": self.tid, "args": dict(self.args)}


@runtime_checkable
class TraceSink(Protocol):
    """Anything that accepts span events.  Emitters additionally read an
    optional ``origin`` attribute (seconds added to every timestamp —
    how the scheduler places group-relative pool times on the serving
    timeline); sinks without one are treated as ``origin = 0.0``."""

    def span(self, span: Span) -> None: ...


class TraceRecorder:
    """The standard in-memory sink: collects spans in emission order.

    ``origin`` is the placement offset the emitting layers add to their
    (group-relative) timestamps; the serving scheduler advances it as its
    virtual timeline progresses.  Standalone pool/executor users can
    leave it at 0.0 — each run is then placed on its own group timeline.
    """

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.origin: float = 0.0

    def span(self, span: Span) -> None:
        self.spans.append(span)

    def clear(self) -> None:
        self.spans.clear()
        self.origin = 0.0

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def __len__(self) -> int:
        return len(self.spans)


def to_jsonl(spans: Iterable[Span]) -> str:
    """One key-sorted JSON object per line, in emission order.

    On the virtual clock every field is a pure function of the seeds, so
    the returned string is byte-identical across runs — the property the
    golden-file and determinism tests pin.
    """
    return "".join(
        json.dumps(s.to_dict(), sort_keys=True, separators=(",", ":")) + "\n"
        for s in spans)


def _track_ids(spans: list[Span]) -> dict[str, int]:
    """Deterministic tid mapping: workers first (numeric order), then the
    remaining tracks in sorted order — stable across emission order."""
    names = sorted({s.tid for s in spans})

    def key(n: str):
        if n.startswith("worker-"):
            try:
                return (0, int(n.split("-", 1)[1]), n)
            except ValueError:
                pass
        return (1, 0, n)

    return {n: i for i, n in enumerate(sorted(names, key=key))}


def to_chrome_trace(spans: Iterable[Span], *, pid: int = 0) -> dict:
    """Chrome-trace / Perfetto JSON of the spans.

    Returns the standard ``{"traceEvents": [...]}`` object: one metadata
    (``ph="M"`` thread_name) event per track, then one complete
    (``ph="X"``) event per span with microsecond ``ts``/``dur``.  Dump
    with ``json.dumps(..., sort_keys=True)`` for byte-stable files.
    """
    spans = list(spans)
    tids = _track_ids(spans)
    events: list[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": i,
         "args": {"name": n}}
        for n, i in sorted(tids.items(), key=lambda kv: kv[1])
    ]
    for s in spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "pid": pid, "tid": tids[s.tid],
            "args": dict(s.args),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
