"""Percentiles, rates and spreads taken over every request."""
import statistics

import numpy as np
import pytest

from benchlib import stats


def test_percentiles_are_numpy_linear_over_all_samples():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 100.0]
    assert stats.percentiles(xs) == {
        f"p{int(p)}": float(np.percentile(xs, p)) for p in (50, 95, 99)}
    assert stats.percentile(xs, 95.0) == pytest.approx(
        5.0 + 0.75 * 95.0)
    assert stats.percentiles([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0}


def test_tail_counts_every_request():
    lat = [0.1] * 95 + [1.0] * 5
    assert stats.percentile(lat, 95.0) == pytest.approx(0.1 + 0.05 * 0.9)
    assert stats.percentile(lat + [10.0] * 10, 95.0) > 1.0


def test_median_is_pythons():
    v = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    assert stats.median(v) == statistics.median(v) == pytest.approx(10.1)


def test_rate_is_all_work_over_all_time():
    # images_per_s: 32 images a request, every request of the window
    lat = [0.1, 0.2, 0.1]
    window = 0.45
    assert 32 * len(lat) / window == pytest.approx(213.333, rel=1e-4)
