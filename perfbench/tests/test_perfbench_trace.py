"""The trace's reduction: device busy time is the union of intervals over
every stream, idle gaps are labelled by the main thread's host op."""
import pytest

from benchlib import trace
from benchlib.trace import WINDOW


def test_union_of_overlapping_stream_intervals():
    ivs = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.merge(ivs) == [[0, 15], [20, 30], [40, 50]]
    assert trace.busy_within(trace.merge(ivs), 0, 60) == 35
    assert trace.busy_within(trace.merge(ivs), 8, 45) == 7 + 10 + 5


def test_gaps():
    merged = trace.merge([(10, 20), (30, 40)])
    assert trace.gaps_within(merged, 0, 50) == [(0, 10), (20, 30), (40, 50)]
    assert trace.gaps_within(merged, 12, 35) == [(20, 30)]


def test_reduce_events_idle_share_and_labels():
    ev = [("host", 0, 1000, WINDOW, 1),
          ("host", 0, 400, "engine", 1), ("host", 100, 300, "aten::mm", 1),
          ("host", 500, 900, "other_thread_op", 2),
          # two streams: 100..300 and 200..500 overlap; 700..800 alone
          ("device", 100, 300, "k1", None), ("device", 200, 500, "k2", None),
          ("device", 700, 800, "k1", None)]
    d = trace.reduce_events(ev, ns=1.0)
    assert d.window_s == 1000
    assert d.busy_s == 400 + 100
    assert d.kernel_s == {"k1": 300.0, "k2": 300.0}
    assert d.kernel_n == {"k1": 2, "k2": 1}
    # gaps 0..100 (engine > mm? 50 lies in engine only), 500..700, 800..1000
    labels = dict(d.idle_gaps)
    assert labels["engine"] == 100
    assert labels["no host op"] == 200 + 200
    assert "other_thread_op" not in labels
    assert d.seconds_of("k") == 600
    assert 1.0 - d.busy_s / d.window_s == pytest.approx(0.5)


def test_innermost_op_labels_a_gap():
    ev = [("host", 0, 100, WINDOW, 1), ("host", 0, 100, "outer", 1),
          ("host", 10, 90, "inner", 1), ("device", 95, 100, "k", None)]
    d = trace.reduce_events(ev, ns=1.0)
    assert dict(d.idle_gaps) == {"inner": 95}
