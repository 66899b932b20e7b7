"""The port's estimator (``core/estimate.py``) and simulator
(``core/runtime.py``), both numpy copies of the reference's.

The first half mirrors tests/test_estimate.py and tests/test_runtime.py on
``repro_torch``; the second holds the copies to ``repro`` by exact equality
over a grid of inputs, compared as plain nested python (the two packages'
dataclasses are distinct classes).
"""
import numpy as np
import pytest

from _torch_parity import plain
from repro.core import estimate as jest
from repro.core import latency as jlat
from repro.core import runtime as jrt
from repro.core import splitting as jsplit
from repro_torch.core import estimate as t_est
from repro_torch.core import latency as tlat
from repro_torch.core import runtime as trt
from repro_torch.core import splitting as tsplit
from repro_torch.core.estimate import (
    ProfileBank,
    WorkerProfile,
    calibrated_params,
    fit_shift_exp,
    round_trip_shift_excess,
)
from repro_torch.core.latency import ShiftExp, SystemParams, phase_sizes
from repro_torch.core.planner import k_circ
from repro_torch.core.runtime import (SimScenario, lt_overhead_samples,
                                      simulate_layer, simulate_network)
from repro_torch.core.schemes import scheme_names
from repro_torch.core.splitting import ConvSpec


# -- mirror of tests/test_estimate.py ----------------------------------------

class TestFitShiftExp:
    @pytest.mark.parametrize("mu,theta,units", [
        (4.0, 0.8, 1.0),
        (0.5, 2.0, 1.0),
        (2e9, 2e-10, 1.0),
        (4.0, 0.8, 3.0),
    ])
    def test_recovers_known_params_within_10pct_at_500(self, mu, theta, units):
        rng = np.random.default_rng(7)
        samples = ShiftExp(mu, theta).scaled(units).sample(rng, (500,))
        fit = fit_shift_exp(samples, units=units)
        assert abs(fit.mu - mu) / mu < 0.10, fit
        assert abs(fit.theta - theta) / theta < 0.10, fit

    def test_theta_from_minimum_mu_from_excess_mean(self):
        samples = [1.0, 1.5, 3.0, 2.5]
        fit = fit_shift_exp(samples, bias_correct=False)
        assert fit.theta == 1.0
        assert fit.mu == pytest.approx(1.0 / (np.mean(samples) - 1.0))

    def test_bias_correction_beats_raw_mle_on_theta(self):
        rng = np.random.default_rng(3)
        raw_err, corr_err = 0.0, 0.0
        for _ in range(200):
            s = ShiftExp(2.0, 1.0).scaled(1.0).sample(rng, (30,))
            raw_err += abs(fit_shift_exp(s, bias_correct=False).theta - 1.0)
            corr_err += abs(fit_shift_exp(s).theta - 1.0)
        assert corr_err < raw_err

    def test_identical_samples_stay_finite(self):
        fit = fit_shift_exp([2.0, 2.0, 2.0, 2.0])
        assert np.isfinite(fit.mu) and fit.mu > 0.0
        assert fit.theta == pytest.approx(2.0, rel=1e-6)

    @pytest.mark.parametrize("bad", [[], [1.0], [1.0, np.nan], [1.0, np.inf]])
    def test_rejects_degenerate_input(self, bad):
        with pytest.raises(ValueError):
            fit_shift_exp(bad)


class TestWorkerProfile:
    def test_ewma_tracks_step_change_within_window(self):
        rng = np.random.default_rng(11)
        p = WorkerProfile(window=32, alpha=0.3)
        for _ in range(128):
            p.observe(float(ShiftExp(2.0, 0.5).scaled(1.0).sample(rng)))
        assert abs(p.mu - 2.0) / 2.0 < 0.6
        for _ in range(32):
            p.observe(float(ShiftExp(8.0, 0.5).scaled(1.0).sample(rng)))
        assert abs(p.mu - 8.0) < abs(p.mu - 2.0)
        assert abs(p.mu - 8.0) / 8.0 < 0.35
        assert abs(p.theta - 0.5) / 0.5 < 0.25

    def test_mean_step_moves_speed(self):
        p = WorkerProfile(window=16, alpha=0.5, min_samples=4)
        for _ in range(16):
            p.observe(1.0)
        fast = p.speed()
        for _ in range(16):
            p.observe(6.0)
        assert fast / p.speed() == pytest.approx(6.0, rel=0.2)

    def test_not_ready_until_min_samples(self):
        p = WorkerProfile(window=8, min_samples=4)
        for i in range(3):
            p.observe(1.0 + i)
            assert not p.ready
        p.observe(4.0)
        assert p.ready

    @pytest.mark.parametrize("dur,units", [(-1.0, 1.0), (np.nan, 1.0),
                                           (1.0, 0.0)])
    def test_rejects_bad_observations(self, dur, units):
        p = WorkerProfile()
        with pytest.raises(ValueError):
            p.observe(dur, units)


class TestProfileBank:
    def test_unobserved_workers_default_to_median_speed(self):
        bank = ProfileBank(window=8, min_samples=2)
        for _ in range(8):
            bank.observe(0, 1.0)
            bank.observe(1, 2.0)
        s = bank.speeds(4)
        med = float(np.median([s[0], s[1]]))
        assert s[2] == s[3] == pytest.approx(med)
        assert s[0] > s[1]

    def test_fleet_fit_pools_all_windows(self):
        rng = np.random.default_rng(5)
        bank = ProfileBank(window=64, min_samples=2)
        for w in range(4):
            for _ in range(64):
                bank.observe(w, float(ShiftExp(3.0, 1.0).scaled(1.0)
                                      .sample(rng)))
        fit = bank.fleet_fit()
        assert abs(fit.mu - 3.0) / 3.0 < 0.10
        assert abs(fit.theta - 1.0) < 0.05


class TestCalibration:
    def test_unit_scales_return_prior_exactly(self):
        prior = SystemParams()
        assert calibrated_params(prior, 1.0, 1.0) == prior

    def test_scales_worker_phases_only(self):
        prior = SystemParams()
        p = calibrated_params(prior, 2.0, 4.0)
        assert p.theta_cmp == prior.theta_cmp * 2.0
        assert p.mu_cmp == prior.mu_cmp / 4.0
        assert p.mu_m == prior.mu_m and p.theta_m == prior.theta_m

    def test_round_trip_decomposition_matches_mean(self):
        spec = ConvSpec(c_in=8, c_out=8, h_in=16, w_in=18, kernel=3)
        prior = SystemParams()
        s = phase_sizes(spec, 8, 4)
        shift, excess = round_trip_shift_excess(s, prior)
        mean = (prior.rec.scaled(s.n_rec).mean()
                + prior.cmp.scaled(s.n_cmp).mean()
                + prior.sen.scaled(s.n_sen).mean())
        assert shift + excess == pytest.approx(mean, rel=1e-12)
        assert shift > 0.0 and excess > 0.0


# -- mirror of tests/test_runtime.py -----------------------------------------

SPEC = ConvSpec(c_in=64, c_out=64, h_in=28, w_in=32, kernel=3, stride=1)
PARAMS = SystemParams(mu_cmp=5e8, mu_rec=2e7, mu_sen=2e7)


def _mean(method, scenario=SimScenario(), n=10, trials=300, k=None,
          params=PARAMS):
    rng = np.random.default_rng(1)
    return float(np.mean([
        simulate_layer(SPEC, n, params, method, k, scenario, rng)
        for _ in range(trials)
    ]))


class TestScenario1Straggling:
    def test_coded_beats_uncoded_when_straggly(self):
        straggly = PARAMS.scaled_tr(3.0)
        k = k_circ(SPEC, 10, straggly)
        assert _mean("coded", k=k, params=straggly) < _mean(
            "uncoded", params=straggly)

    def test_uncoded_wins_when_benign(self):
        benign = SystemParams(mu_cmp=1e12, mu_rec=1e10, mu_sen=1e10)
        k = k_circ(SPEC, 10, benign)
        assert _mean("uncoded", params=benign) < _mean(
            "coded", k=k, params=benign) * 1.05


class TestScenario2Failure:
    @pytest.mark.parametrize("n_fail", [1, 2])
    def test_failures_hurt_uncoded_more(self, n_fail):
        sc = SimScenario(n_fail=n_fail)
        k = min(k_circ(SPEC, 10, PARAMS), 10 - n_fail)
        assert _mean("coded", sc, k=k) < _mean("uncoded", sc)

    def test_uncoded_latency_increases_with_failures(self):
        mild = SystemParams()
        m0 = _mean("uncoded", params=mild)
        m2 = _mean("uncoded", SimScenario(n_fail=2), params=mild)
        assert m2 > m0 * 1.25, (m0, m2)

    def test_coded_stable_under_failures_within_redundancy(self):
        m0 = _mean("coded", k=6)
        m2 = _mean("coded", SimScenario(n_fail=2), k=6)
        assert m2 < m0 * 1.35


class TestScenario3Mixed:
    def test_straggler_plus_failure(self):
        sc = SimScenario(n_fail=1, straggler_slow=4.0)
        k = min(k_circ(SPEC, 10, PARAMS), 8)
        assert _mean("coded", sc, k=k) < _mean("uncoded", sc)


class TestLT:
    def test_overhead_at_least_k(self):
        assert min(lt_overhead_samples(8)) >= 8

    def test_lt_runs(self):
        m = _mean("lt", SimScenario(lt_k=8))
        assert np.isfinite(m) and m > 0


class TestNetwork:
    def test_network_sum_of_layers(self):
        lat = simulate_network([SPEC, SPEC], 10, PARAMS, "coded", trials=5)
        one = simulate_network([SPEC], 10, PARAMS, "coded", trials=5)
        assert lat.shape == (5,)
        assert lat.mean() > one.mean()


# -- exact equality with the reference ---------------------------------------

def _params(mod, i):
    if i == 0:
        return mod.SystemParams()
    return mod.SystemParams(mu_m=2.5e9, theta_m=4e-10, mu_cmp=4e9,
                            theta_cmp=1.35e-9, mu_rec=1.5e7, theta_rec=3e-7,
                            mu_sen=1.5e7, theta_sen=3e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m", [2, 3, 17, 200])
def test_fit_shift_exp_equal(seed, m):
    rng = np.random.default_rng(seed)
    samples = 0.3 + rng.exponential(0.7, m)
    units = rng.uniform(0.5, 4.0, m)
    for kw in ({}, {"units": 2.5}, {"units": units},
               {"bias_correct": False}, {"units": units,
                                         "bias_correct": False}):
        assert plain(t_est.fit_shift_exp(samples, **kw)) == \
            plain(jest.fit_shift_exp(samples, **kw)), kw
    for unit in ([1.0, 1.0], [2.0, 2.0, 2.0], [5.0, 0.0]):
        assert plain(t_est.fit_shift_exp(unit)) == \
            plain(jest.fit_shift_exp(unit))


def _profile_state(p):
    return (p.n_observed, p.mu, p.theta, p.ready, p.window_samples(),
            p.mean() if p.mu is not None else None)


@pytest.mark.parametrize("window,alpha,min_samples", [
    (2, 1.0, 1), (8, 0.25, 4), (32, 0.5, 8), (64, 0.1, 2)])
def test_worker_profile_equal(window, alpha, min_samples):
    rng = np.random.default_rng(window)
    tp = t_est.WorkerProfile(window, alpha, min_samples=min_samples)
    jp = jest.WorkerProfile(window, alpha, min_samples=min_samples)
    assert _profile_state(tp) == _profile_state(jp)
    for i in range(90):
        dur = float(0.5 + rng.exponential(1.0 if i < 50 else 4.0))
        units = float(rng.uniform(0.5, 3.0))
        t = None if i % 3 else float(i) * 0.5
        tp.observe(dur, units, t=t)
        jp.observe(dur, units, t=t)
        assert _profile_state(tp) == _profile_state(jp), i
        if i in (40, 70):
            tp.reset_at(float(i) * 0.4)
            jp.reset_at(float(i) * 0.4)
            assert _profile_state(tp) == _profile_state(jp), i
    assert plain(tp.fit()) == plain(jp.fit())
    assert tp.speed() == jp.speed()
    tp.reset_at(1e9)
    jp.reset_at(1e9)
    assert _profile_state(tp) == _profile_state(jp)


@pytest.mark.parametrize("seed", [0, 1])
def test_profile_bank_equal(seed):
    rng = np.random.default_rng(seed)
    tb = t_est.ProfileBank(window=16, alpha=0.3, min_samples=4)
    jb = jest.ProfileBank(window=16, alpha=0.3, min_samples=4)
    assert tb.ready == jb.ready
    assert tb.speeds(5) == jb.speeds(5)
    for i in range(120):
        w = int(rng.integers(0, 6))
        dur = float(rng.exponential(1.0 + 5.0 * (w == 2)) + 0.2)
        tb.observe(w, dur, units=1.5, t=float(i))
        jb.observe(w, dur, units=1.5, t=float(i))
        if i % 11 == 0:
            assert tb.ready == jb.ready
            assert tb.speeds(8) == jb.speeds(8)
            assert tb.speeds(8, default=0.5) == jb.speeds(8, default=0.5)
            if tb.ready:
                assert plain(tb.fleet_fit()) == plain(jb.fleet_fit())
    tb.reset_at(100.0)
    jb.reset_at(100.0)
    assert tb.speeds(8) == jb.speeds(8)
    assert plain(tb.fleet_fit()) == plain(jb.fleet_fit())
    assert sorted(tb.profiles) == sorted(jb.profiles)


@pytest.mark.parametrize("pi", [0, 1])
def test_calibration_equal(pi):
    for s in [(16, 16, 32, 34, 3), (64, 64, 28, 32, 3), (2048, 8192, 1, 8, 1),
              (512, 512, 16, 16, 3)]:
        tspec = tsplit.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                                kernel=s[4])
        jspec = jsplit.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                                kernel=s[4])
        for k in (1, 3, 6):
            ts = tlat.phase_sizes(tspec, 10, k)
            js = jlat.phase_sizes(jspec, 10, k)
            assert t_est.round_trip_shift_excess(ts, _params(tlat, pi)) == \
                jest.round_trip_shift_excess(js, _params(jlat, pi))
    for th, ex in ((1.0, 1.0), (0.0, 0.5), (2.5, 3.0), (1e-3, 1e4)):
        assert plain(t_est.calibrated_params(_params(tlat, pi), th, ex)) == \
            plain(jest.calibrated_params(_params(jlat, pi), th, ex))
    for bad in ((-1.0, 1.0), (1.0, 0.0)):
        with pytest.raises(ValueError):
            t_est.calibrated_params(_params(tlat, pi), *bad)


SCENARIOS = [  # (n_fail, straggler_slow, lambda_tr, lt_k)
    (0, 1.0, 0.0, None), (2, 1.0, 0.0, None), (0, 4.0, 0.5, None),
    (1, 3.0, 1.0, 6)]


def _scenario(mod, sc):
    kw = dict(n_fail=sc[0], straggler_slow=sc[1], lambda_tr=sc[2])
    if sc[3] is not None:
        kw["lt_k"] = sc[3]
    return mod.SimScenario(**kw)


@pytest.mark.parametrize("sc", SCENARIOS)
@pytest.mark.parametrize("method", scheme_names())
def test_simulate_equal(method, sc):
    """Every registered scheme, with and without failures, stragglers and
    channel contention: the same draws from the same seeds."""
    s = (64, 64, 28, 32, 3)
    tspec = tsplit.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                            kernel=s[4])
    jspec = jsplit.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                            kernel=s[4])
    tp = tlat.SystemParams(mu_cmp=5e8, mu_rec=2e7, mu_sen=2e7)
    jp = jlat.SystemParams(mu_cmp=5e8, mu_rec=2e7, mu_sen=2e7)
    tsc, jsc = _scenario(trt, sc), _scenario(jrt, sc)
    k = None if method in ("uncoded", "replication") else 6
    for seed in (0, 3):
        assert trt.simulate_layer(
            tspec, 10, tp, method, k, tsc, np.random.default_rng(seed)) == \
            jrt.simulate_layer(jspec, 10, jp, method, k, jsc,
                               np.random.default_rng(seed))
        assert trt.simulate_layer_batch(
            tspec, 10, tp, method, k, tsc, np.random.default_rng(seed),
            trials=40).tolist() == jrt.simulate_layer_batch(
            jspec, 10, jp, method, k, jsc, np.random.default_rng(seed),
            trials=40).tolist()
    t2 = tsplit.ConvSpec(c_in=16, c_out=32, h_in=14, w_in=20, kernel=3)
    j2 = jsplit.ConvSpec(c_in=16, c_out=32, h_in=14, w_in=20, kernel=3)
    ks = None if k is None else [6, 4]
    assert trt.simulate_network([tspec, t2], 10, tp, method, ks, tsc,
                                trials=12, seed=5).tolist() == \
        jrt.simulate_network([jspec, j2], 10, jp, method, ks, jsc,
                             trials=12, seed=5).tolist()


def test_lt_overhead_samples_equal():
    for k in (4, 8):
        assert plain(trt.lt_overhead_samples(k, trials=50, seed=3)) == \
            plain(jrt.lt_overhead_samples(k, trials=50, seed=3))
