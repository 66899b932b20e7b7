"""Telemetry of coded runs: span traces of the pool and the executor
(:mod:`.trace`, a copy of the reference's ``repro.telemetry.trace``)."""
from .trace import (
    Span,
    TraceRecorder,
    TraceSink,
    to_chrome_trace,
    to_jsonl,
)

__all__ = [
    "Span",
    "TraceRecorder",
    "TraceSink",
    "to_chrome_trace",
    "to_jsonl",
]
