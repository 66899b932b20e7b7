"""Percentiles and medians taken over every sample of a run.

``percentiles`` is a copy of ``repro_torch.serving.metrics.percentiles``
(numpy's linear interpolation)."""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np

PCTS = (50.0, 95.0, 99.0)


def percentiles(xs: Sequence[float], pcts: Sequence[float] = PCTS) -> dict:
    """{"p50": ..., "p95": ..., "p99": ...} (NaN-free; empty -> zeros)."""
    if len(xs) == 0:
        return {f"p{int(p)}": 0.0 for p in pcts}
    arr = np.asarray(list(xs), np.float64)
    return {f"p{int(p)}": float(np.percentile(arr, p)) for p in pcts}


def percentile(xs: Sequence[float], p: float) -> float:
    return percentiles(xs, (p,))[f"p{int(p)}"]


def median(xs: Sequence[float]) -> float:
    return float(statistics.median(xs))
