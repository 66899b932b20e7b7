"""Arithmetic shared by the per-layer readers of several cells."""
from __future__ import annotations

from benchlib import roofline


def idle_share(obs, kind: str):
    """100 x (1 - busy / window) of the traced window, or None."""
    data = obs.trace
    if obs.kind != kind or data is None or data.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)


def mfu(obs, kind: str):
    """The plain model's matrix FLOPs completed in the traced window over
    the window at the configuration's peak, in %, or None."""
    data = obs.trace
    if obs.kind != kind or data is None or data.window_s <= 0.0:
        return None
    flops = obs.traced_flops if kind != "cnn" else (
        obs.traced_requests * obs.model_flops)
    if flops <= 0.0:
        return None
    return 100.0 * flops / (data.window_s * roofline.PEAK_FLOPS[obs.dtype])
