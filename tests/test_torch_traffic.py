"""The port's open-loop traffic generation (``repro_torch.serving.traffic``,
a numpy copy of the reference's): tests/test_traffic.py on the port, and
exact equality with the reference's ``Workload.generate`` for the same
seeds under every arrival process (a seed must give the same requests in
both packages, bit for bit)."""
import numpy as np
import pytest

from repro.serving import traffic as jtraffic
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.traffic import (BurstyArrivals, LengthDist,
                                         PoissonArrivals, SharedPrefixDist,
                                         TraceArrivals, Workload)


def _rng(seed=0):
    return np.random.default_rng(seed)


class TestPoisson:
    def test_deterministic(self):
        a = PoissonArrivals(3.0).arrival_times(50, _rng(7))
        b = PoissonArrivals(3.0).arrival_times(50, _rng(7))
        np.testing.assert_array_equal(a, b)

    def test_sorted_positive(self):
        t = PoissonArrivals(2.0).arrival_times(100, _rng())
        assert (np.diff(t) >= 0).all() and t[0] > 0

    def test_rate_statistical(self):
        # 2000 exponential gaps at rate 5: mean gap within 10% of 1/5
        t = PoissonArrivals(5.0).arrival_times(2000, _rng(1))
        assert np.mean(np.diff(t)) == pytest.approx(0.2, rel=0.1)

    def test_rejects_bad_rate(self):
        with pytest.raises(ValueError, match="rate"):
            PoissonArrivals(0.0)


class TestBursty:
    def test_deterministic_sorted(self):
        p = BurstyArrivals(1.0, 50.0, mean_calm_s=2.0, mean_burst_s=0.5)
        a = p.arrival_times(200, _rng(3))
        b = p.arrival_times(200, _rng(3))
        np.testing.assert_array_equal(a, b)
        assert (np.diff(a) >= 0).all()
        assert len(a) == 200

    def test_mean_rate_between_phase_rates(self):
        p = BurstyArrivals(1.0, 50.0, mean_calm_s=2.0, mean_burst_s=2.0)
        t = p.arrival_times(3000, _rng(5))
        rate = len(t) / t[-1]
        assert 1.0 < rate < 50.0

    def test_burstier_than_poisson(self):
        # squared coefficient of variation of gaps: Poisson == 1, MMPP > 1
        p = BurstyArrivals(0.5, 80.0, mean_calm_s=4.0, mean_burst_s=1.0)
        gaps = np.diff(p.arrival_times(3000, _rng(11)))
        cv2 = np.var(gaps) / np.mean(gaps) ** 2
        assert cv2 > 1.5

    def test_validation(self):
        with pytest.raises(ValueError):
            BurstyArrivals(0.0, 1.0, 1.0, 1.0)
        with pytest.raises(ValueError):
            BurstyArrivals(1.0, 1.0, 0.0, 1.0)


class TestTrace:
    def test_replay(self):
        tr = TraceArrivals((0.0, 0.5, 0.5, 2.0))
        np.testing.assert_array_equal(tr.arrival_times(3, _rng()),
                                      [0.0, 0.5, 0.5])

    def test_overdraw_is_error(self):
        with pytest.raises(ValueError, match="holds 2"):
            TraceArrivals((0.0, 1.0)).arrival_times(3, _rng())

    def test_rejects_unsorted(self):
        with pytest.raises(ValueError, match="non-decreasing"):
            TraceArrivals((1.0, 0.5))


class TestLengthDist:
    def test_fixed(self):
        d = LengthDist.fixed(7)
        assert d.sample(_rng()) == 7 and d.max_value == 7

    def test_samples_from_values(self):
        d = LengthDist((4, 8, 16))
        rng = _rng(2)
        seen = {d.sample(rng) for _ in range(100)}
        assert seen == {4, 8, 16}
        assert d.max_value == 16

    def test_probs_respected(self):
        d = LengthDist((4, 8), probs=(1.0, 0.0))
        rng = _rng()
        assert all(d.sample(rng) == 4 for _ in range(20))

    def test_validation(self):
        with pytest.raises(ValueError):
            LengthDist(())
        with pytest.raises(ValueError):
            LengthDist((0,))
        with pytest.raises(ValueError):
            LengthDist((4, 8), probs=(0.5,))
        with pytest.raises(ValueError):
            LengthDist((4, 8), probs=(0.9, 0.2))


class TestWorkload:
    def _wl(self, seed=0):
        return Workload(PoissonArrivals(2.0), LengthDist((4, 6)),
                        LengthDist((2, 3)), vocab=32, seed=seed)

    def test_deterministic_stream(self):
        a, b = self._wl().generate(20), self._wl().generate(20)
        for ra, rb in zip(a, b):
            assert ra.arrival_s == rb.arrival_s
            assert ra.max_new == rb.max_new
            np.testing.assert_array_equal(ra.prompt, rb.prompt)

    def test_seed_changes_stream(self):
        a, b = self._wl(0).generate(20), self._wl(1).generate(20)
        assert [r.arrival_s for r in a] != [r.arrival_s for r in b]

    def test_requests_well_formed(self):
        reqs = self._wl().generate(30)
        assert [r.rid for r in reqs] == list(range(30))
        arr = [r.arrival_s for r in reqs]
        assert arr == sorted(arr) and arr[0] > 0.0
        for r in reqs:
            assert len(r.prompt) in (4, 6) and r.max_new in (2, 3)
            assert r.prompt.dtype == np.int32
            assert (0 <= r.prompt).all() and (r.prompt < 32).all()
            assert len(r.prompt) + r.max_new <= self._wl().max_seq

    def test_max_seq_covers_extremes(self):
        assert self._wl().max_seq == 6 + 3


# ---------------------------------------------------------------------------
# exact parity with the reference
# ---------------------------------------------------------------------------

def _arrivals(mod, kind):
    if kind == "poisson":
        return mod.PoissonArrivals(3.5)
    if kind == "bursty":
        return mod.BurstyArrivals(0.5, 40.0, mean_calm_s=3.0, mean_burst_s=0.7)
    return mod.TraceArrivals(tuple(0.25 * i * i for i in range(40)))


def _workload(mod, kind, seed, shared):
    sp = (mod.SharedPrefixDist(3, 12, mod.LengthDist((2, 5, 9)), zipf_a=1.1,
                               vocab=50, seed=seed + 1) if shared else None)
    return mod.Workload(_arrivals(mod, kind), mod.LengthDist((4, 6, 9),
                                                             (0.2, 0.5, 0.3)),
                        mod.LengthDist((1, 2, 3)), vocab=50, seed=seed,
                        shared_prefix=sp)


@pytest.mark.parametrize("shared", [False, True], ids=["uniform", "prefix"])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "trace"])
def test_workload_equals_the_reference(kind, shared):
    for seed in (0, 7):
        got = _workload(ttraffic, kind, seed, shared)
        want = _workload(jtraffic, kind, seed, shared)
        assert got.max_seq == want.max_seq
        a, b = got.generate(30), want.generate(30)
        assert len(a) == len(b) == 30
        for ra, rb in zip(a, b):
            assert (ra.rid, ra.max_new, ra.arrival_s) == \
                (rb.rid, rb.max_new, rb.arrival_s)
            assert ra.prompt.dtype == rb.prompt.dtype == np.int32
            np.testing.assert_array_equal(ra.prompt, rb.prompt)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "trace"])
def test_arrival_times_equal_the_reference(kind):
    got = _arrivals(ttraffic, kind)
    want = _arrivals(jtraffic, kind)
    np.testing.assert_array_equal(got.arrival_times(25, _rng(3)),
                                  want.arrival_times(25, _rng(3)))


def test_shared_prefix_prompts_reuse_families():
    sp = SharedPrefixDist(2, 8, LengthDist((3,)), zipf_a=2.0, vocab=40,
                          seed=5)
    rng = _rng(1)
    prompts = [sp.sample_prompt(rng) for _ in range(20)]
    heads = {tuple(p[:8]) for p in prompts}
    assert len(heads) <= 2 and all(len(p) == 11 for p in prompts)
    assert sp.max_value == 11
    with pytest.raises(ValueError):
        SharedPrefixDist(0, 8, LengthDist((3,)))
