"""Telemetry of coded runs: span traces of the pool and the executor
(:mod:`.trace`) and the SLO breach explainer (:mod:`.explain`), copies of
the reference's ``repro.telemetry.trace`` and ``repro.telemetry.explain``;
beside them :func:`.trace.span`, the port's own live spans on the torch
profiler's clock.

Detected regime shifts feed ``AdaptivePlanner.reset_at`` and
``AdaptivePlanner.replan_segments`` (``repro_torch.dist.adaptive``), so
segment boundaries adapt to drift, not just k°.
"""
from .trace import (
    span,
    Span,
    TraceRecorder,
    TraceSink,
    to_chrome_trace,
    to_jsonl,
)
from .explain import (
    BreachDataset,
    Culprit,
    CulpritReport,
    FeatureKey,
    RegimeSplit,
    candidate_predicates,
    detect_regimes,
    explain_breaches,
    features_from_report,
    search_culprits,
)

__all__ = [
    "span",
    "Span",
    "TraceRecorder",
    "TraceSink",
    "to_chrome_trace",
    "to_jsonl",
    "BreachDataset",
    "Culprit",
    "CulpritReport",
    "FeatureKey",
    "RegimeSplit",
    "candidate_predicates",
    "detect_regimes",
    "explain_breaches",
    "features_from_report",
    "search_culprits",
]
