"""The general traffic generator: the same seed gives the same traffic,
and every seed offers the same requests in another order."""
import collections
import json

import numpy as np
import pytest

from benchlib import spec
from benchlib import traffic as tr

MIX = json.loads(spec.traffic_path("poisson_long_prompts").read_text())
CLOSED = json.loads(spec.traffic_path("closed_b128").read_text())
BIG = 2 ** 31 + 12345


def key(reqs):
    return [(r.rid, r.prompt.tobytes(), r.max_new, r.arrival_s) for r in reqs]


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_same_seed_same_traffic(seed):
    a = tr.open_loop(MIX, 51.0, seed, 32000)
    b = tr.open_loop(MIX, 51.0, seed, 32000)
    assert key(a) == key(b)
    assert tr.closed_loop_inputs(CLOSED, 500, seed).tolist() == \
        tr.closed_loop_inputs(CLOSED, 500, seed).tolist()


def test_fixed_work_is_the_same_for_every_seed():
    rate = MIX["arrivals"]["rate"]
    runs = [tr.open_loop(MIX, 51.0, s, 32000) for s in (1, 2, BIG)]
    n = int(round(MIX["requests_per_s"] * 51.0))
    for reqs in runs:
        assert len(reqs) == n
        assert sorted(len(r.prompt) for r in reqs) == \
            sorted(len(r.prompt) for r in runs[0])
        assert sorted(r.max_new for r in reqs) == \
            sorted(r.max_new for r in runs[0])
        gaps = np.diff([r.arrival_s for r in reqs])
        assert np.all(gaps > 0.0)
        assert reqs[-1].arrival_s < n / rate
    assert key(runs[0]) != key(runs[1])
    counts = collections.Counter(len(r.prompt) for r in runs[0])
    want = tr.apportion(n, MIX["prompt_len"]["probs"])
    assert [counts[v] for v in MIX["prompt_len"]["values"]] == want.tolist()
    assert {r.max_new for r in runs[0]} == set(range(2, 7))


def test_fixed_gaps_have_the_rate():
    reqs = tr.open_loop(dict(MIX, requests_per_s=MIX["arrivals"]["rate"]),
                        51.0, 5, 32000)
    rate = MIX["arrivals"]["rate"]
    span = reqs[-1].arrival_s
    # n - 1 of the n gaps: the mean gap is 1 / rate
    assert span == pytest.approx((len(reqs) - 1) / rate, rel=0.05)


@pytest.mark.parametrize("per_s,seconds", [(5.0, 51.0), (0.5, 3.0),
                                            (2.5, 1.0)])
def test_count_is_requests_per_s_times_seconds(per_s, seconds):
    reqs = tr.open_loop(dict(MIX, requests_per_s=per_s), seconds, 3, 1000)
    assert len(reqs) == max(1, round(per_s * seconds))
    assert [r.rid for r in reqs] == list(range(len(reqs)))
    assert reqs[0].arrival_s == 0.0
    assert all(0 <= int(t) < 1000 for r in reqs for t in r.prompt)


def test_apportion():
    assert tr.apportion(10, [0.4, 0.3, 0.2, 0.1]).tolist() == [4, 3, 2, 1]
    assert tr.apportion(7, [0.5, 0.5]).sum() == 7


def test_closed_loop_cycles_every_input():
    idx = tr.closed_loop_inputs(CLOSED, 40, 9)
    p = CLOSED["distinct_inputs"]
    for i in range(0, 40 - p + 1, p):
        assert sorted(idx[i:i + p].tolist()) == list(range(p))


def test_other_arrival_processes_and_kinds_are_refused():
    bursty = dict(MIX, arrivals={"process": "bursty", "rate_calm": 1.0,
                                 "rate_burst": 20.0, "mean_calm_s": 5.0,
                                 "mean_burst_s": 1.0})
    with pytest.raises(ValueError, match="bursty"):
        tr.open_loop(bursty, 30.0, 4, 1000)
    with pytest.raises(ValueError):
        tr.open_loop(CLOSED, 30.0, 4, 1000)
    with pytest.raises(ValueError):
        tr.closed_loop_inputs(MIX, 10, 4)
