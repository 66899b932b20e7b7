"""The port's SLO breach explainer (``telemetry/explain.py``, a numpy copy
of the reference's) and the estimator's regime reset.

Mirrors the explainer and reset tests of tests/test_telemetry.py on
``repro_torch`` (features, regime detection, candidate predicates, the
exact search and the GA fallback, determinism), then holds the port to the
reference: feature rows from the port's pool and from the reference's pool
on the same FakeClock scenario are equal, and the ranked reports serialize
to the same bytes.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import plain
from repro import dist as jdist
from repro import telemetry as jtel
from repro.core import latency as jlat
from repro.core.schemes import get_scheme as jget_scheme
from repro_torch import dist as tdist
from repro_torch import telemetry as ttel
from repro_torch.core.estimate import ProfileBank, WorkerProfile, fit_shift_exp
from repro_torch.core.latency import SystemParams
from repro_torch.core.schemes import get_scheme
from repro_torch.dist import (AdaptivePlanner, CodedExecutor, FakeClock,
                              LayerSlowdown, SegmentDelay)
from repro_torch.telemetry import (BreachDataset, FeatureKey,
                                   candidate_predicates, detect_regimes,
                                   explain_breaches, features_from_report)

WIFI = dict(mu_m=2.5e9, theta_m=4e-10, mu_cmp=4e9, theta_cmp=1.35e-9,
            mu_rec=1.5e7, theta_rec=3e-7, mu_sen=1.5e7, theta_sen=3e-7)
N = 4
N_REQ, SHIFT, FACTOR = 30, 15, 12.0
CULPRIT = (1, "cmp", 2)  # worker 1's layer-2 compute slows by FACTOR


def _lsz(lat, dist, n_layers=4):
    return dist.per_layer_sizes([lat.PhaseSizes(
        n_enc=0.0, n_cmp=2e6, n_rec=1e4, n_sen=1e4, n_dec=0.0)
        for _ in range(n_layers)])


def _forensics_dataset(port=True):
    """Scripted drift (the reference test's): healthy segment chains, then
    worker 1's layer-2 stage slows FACTOR x from request SHIFT on.  The
    same scenario on either package's pool."""
    if port:
        from repro_torch.core import latency as lat
        dist, tel, scheme = tdist, ttel, get_scheme
        piece = lambda: torch.ones((2, 2))  # noqa: E731
    else:
        lat, dist, tel, scheme = jlat, jdist, jtel, jget_scheme
        piece = lambda: jnp.ones((2, 2))  # noqa: E731
    lsz = _lsz(lat, dist)
    rows, walls = [], []
    with dist.CodedExecutor(N, clock=dist.FakeClock()) as ex:
        for r in range(N_REQ):
            delay = dist.SegmentDelay(lat.SystemParams(**WIFI), lsz,
                                      seed=100 + r)
            if r >= SHIFT:
                delay = dist.LayerSlowdown(
                    delay, {CULPRIT[0]: {CULPRIT[2]: FACTOR}})
            ex.run(scheme("uncoded").make(N), [piece] * N,
                   delay_model=delay, gather_all=True)
            rep = ex.last_report
            rows.append(tel.features_from_report(rep, per_layer=True))
            walls.append(rep.t_complete - rep.t_submit)
    slo = 1.05 * max(walls[:SHIFT])
    return rows, [w > slo for w in walls], [float(r) for r in range(N_REQ)]


@pytest.fixture(scope="module")
def forensics():
    return _forensics_dataset()


class TestRegimeDetection:
    def test_planted_mean_shift_found(self):
        v = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 5.2, 4.9, 5.1, 5.0]
        sp = detect_regimes(v)
        assert sp.split == 5
        assert sp.lift == pytest.approx(5.0, rel=0.1)
        assert sp.score > 1.0

    def test_too_short_returns_none(self):
        assert detect_regimes([1.0, 2.0, 3.0, 4.0, 5.0], min_seg=3) is None

    def test_nan_keeps_original_indexing(self):
        v = [np.nan, 1.0, 1.0, 1.0, np.nan, 5.0, 5.0, 5.0]
        sp = detect_regimes(v, min_seg=3)
        assert sp.split == 5
        assert sp.mean_pre == pytest.approx(1.0)

    def test_flat_series_scores_zero(self):
        sp = detect_regimes([2.0] * 12)
        assert sp is not None and sp.score == 0.0


class TestExplainer:
    def test_recovers_scripted_culprit(self, forensics):
        rows, breach, times = forensics
        assert any(breach) and not all(breach)
        rep = explain_breaches(rows, breach, times)
        assert rep.method == "bnb"
        assert rep.precision >= 0.9 and rep.recall >= 0.9
        top = rep.culprits[0]
        assert (top.worker, top.phase, top.layer) == CULPRIT
        assert top.shift_at == pytest.approx(float(SHIFT), abs=1.0)
        assert "worker 1" in rep.describe()

    def test_report_bytes_deterministic(self, forensics):
        rows, breach, times = forensics
        a = explain_breaches(rows, breach, times).to_json()
        rows2, breach2, times2 = _forensics_dataset()
        b = explain_breaches(rows2, breach2, times2).to_json()
        assert a == b
        json.loads(a)

    def test_ga_agrees_with_bnb(self, forensics):
        rows, breach, times = forensics
        exact = explain_breaches(rows, breach, times)
        ga = explain_breaches(rows, breach, times, max_exact=0, seed=0)
        assert ga.method == "ga"
        assert ga.f1 == pytest.approx(exact.f1)
        assert {(c.worker, c.phase, c.layer) for c in ga.culprits} \
            >= {(c.worker, c.phase, c.layer) for c in exact.culprits}

    def test_no_breaches_no_culprits(self, forensics):
        rows, _, times = forensics
        rep = explain_breaches(rows, [False] * len(rows), times)
        assert rep.method == "none" and rep.culprits == ()
        assert rep.describe() == "no culprit found"

    def test_dataset_series_and_fires(self):
        k = FeatureKey(0, "cmp", 0)
        ds = BreachDataset([{k: 1.0}, {}, {k: 3.0}], [False, False, True])
        s = ds.series(k)
        assert s[0] == 1.0 and np.isnan(s[1]) and s[2] == 3.0
        assert ds.fires(k, 2.0).tolist() == [False, False, True]
        assert ds.distributions()[k].tolist() == [1.0, 3.0]
        with pytest.raises(ValueError):
            BreachDataset([{k: 1.0}], [True, False])
        with pytest.raises(ValueError):
            BreachDataset([{k: 1.0}], [True], times=[0.0, 1.0])

    def test_candidates_keep_only_features_that_rose(self, forensics):
        rows, breach, times = forensics
        preds = candidate_predicates(BreachDataset(rows, breach, times))
        keys = {(p.key.worker, p.key.phase, p.key.layer) for p in preds}
        assert CULPRIT in keys
        for p in preds:
            assert p.split.lift >= 1.2 and p.split.score >= 1.0
            assert p.threshold == pytest.approx(
                0.5 * (p.split.mean_pre + p.split.mean_post))


class TestFeatures:
    def _report(self, timings):
        return tdist.RunReport(0.0, 0.0, [], [], [], [], [], {},
                               timings=timings)

    def test_gemm_stages_per_layer_and_round_trip(self):
        PT = tdist.PieceTiming
        rep = self._report([
            PT(0, 0, 0.0, 3.0, 3.0, stages=(1.0, 1.5, 0.5)),
            PT(0, 1, 3.0, 4.0, 7.0, stages=(2.0, 1.0, 1.0)),
            PT(1, 2, 0.0, 2.5, 2.5),
            PT(2, 3, 0.0, 4.0, 4.0, stages=(1.0, 3.0))])
        f = features_from_report(rep)
        assert f[FeatureKey(0, "rec", 0)] == 2.0   # slowest sample per key
        assert f[FeatureKey(0, "cmp", 0)] == 1.5
        assert f[FeatureKey(1, "rt", 0)] == 2.5
        assert f[FeatureKey(2, "rt", 0)] == 4.0    # 2 stages: not a GEMM
        g = features_from_report(rep, per_layer=True)
        assert g[FeatureKey(0, "cmp", 2)] == 1.0
        assert g[FeatureKey(2, "cmp", 1)] == 3.0
        assert FeatureKey(0, "rec", 0) not in g
        assert FeatureKey(2, "cmp", 0).label() == "worker 2/cmp/layer 0"


class TestEstimatorReset:
    def _fed_profile(self):
        rng = np.random.default_rng(0)
        pre = 1.0 + rng.exponential(0.2, 40)
        post = 5.0 + rng.exponential(0.2, 12)
        prof = WorkerProfile(window=64, alpha=0.25, min_samples=2)
        for i, u in enumerate(pre):
            prof.observe(float(u), t=float(i))
        for j, u in enumerate(post):
            prof.observe(float(u), t=float(len(pre) + j))
        return prof, post

    def test_post_shift_fit_recovered_exactly(self):
        prof, post = self._fed_profile()
        assert prof.fit().theta < 4.0
        prof.reset_at(40.0)
        clean = fit_shift_exp([float(u) for u in post])
        assert prof.fit().mu == pytest.approx(clean.mu)
        assert prof.fit().theta == pytest.approx(clean.theta)
        assert prof.n_observed == len(post)

    def test_reset_below_min_samples_goes_unready(self):
        prof, post = self._fed_profile()
        prof.reset_at(float(40 + len(post) - 1))
        assert not prof.ready

    def test_bank_forwards_to_all_profiles(self):
        bank = ProfileBank(min_samples=2)
        for w in (0, 1):
            for i in range(6):
                bank.observe(w, 1.0 + 0.1 * i, t=float(i))
        bank.reset_at(4.0)
        for w in (0, 1):
            assert bank.profile(w).n_observed == 2

    def test_planner_layer_scales_and_reset(self):
        from repro_torch.core import latency as lat

        lsz = _lsz(lat, tdist)
        prior = SystemParams(**WIFI)
        planner = AdaptivePlanner(prior, min_samples=4)
        slow = LayerSlowdown(SegmentDelay(prior, lsz, seed=0),
                             {w: {2: 8.0} for w in range(N)})
        mds = get_scheme("mds").make(N, 3)
        with CodedExecutor(N, clock=FakeClock()) as ex:
            for r in range(10):
                ex.run(mds, [lambda: torch.ones((2, 2))] * N,
                       delay_model=SegmentDelay(prior, lsz, seed=200 + r),
                       gather_all=True)
                planner.observe_report(ex.last_report, lsz, at=float(r))
            for r in range(10, 22):
                ex.run(mds, [lambda: torch.ones((2, 2))] * N,
                       delay_model=dataclasses.replace(
                           slow, inner=SegmentDelay(prior, lsz,
                                                    seed=200 + r)),
                       gather_all=True)
                planner.observe_report(ex.last_report, lsz, at=float(r))
        blended = planner.layer_scales(range(4))[2]
        planner.reset_at(10.0)
        scales = planner.layer_scales(range(4))
        assert scales[2] > max(4.0, blended)
        for j in (0, 1, 3):
            assert 0.5 < scales[j] < 2.0


# -- the port against the reference ------------------------------------------

def _plain_rows(rows):
    return [sorted(((k.worker, k.phase, k.layer), v) for k, v in r.items())
            for r in rows]


def test_feature_rows_equal_the_reference(forensics):
    rows, breach, times = forensics
    jrows, jbreach, jtimes = _forensics_dataset(port=False)
    assert _plain_rows(rows) == _plain_rows(jrows)
    assert breach == jbreach and times == jtimes


@pytest.mark.parametrize("kw", [{}, {"max_exact": 0, "seed": 0},
                                {"max_exact": 0, "seed": 3},
                                {"min_lift": 1.05, "min_score": 0.5},
                                {"min_seg": 5}])
def test_report_bytes_equal_the_reference(forensics, kw):
    rows, breach, times = forensics
    jrows = [{jtel.FeatureKey(k.worker, k.phase, k.layer): v
              for k, v in r.items()} for r in rows]
    got = explain_breaches(rows, breach, times, **kw)
    want = jtel.explain_breaches(jrows, breach, times, **kw)
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_datasets_equal_the_reference(seed):
    """Random rows with gaps and planted shifts on random keys: regimes,
    candidates and both searches agree with the reference exactly."""
    rng = np.random.default_rng(seed)
    n_req, shift = 24, int(rng.integers(6, 18))
    keys = [(w, ph, l) for w in range(5) for ph in ("rt", "cmp")
            for l in range(2)]
    culprits = {keys[i] for i in rng.choice(len(keys), 2, replace=False)}
    rows, jrows = [], []
    for r in range(n_req):
        row = {}
        for key in keys:
            if rng.random() < 0.15:
                continue
            v = float(1.0 + rng.exponential(0.1))
            if key in culprits and r >= shift:
                v *= 4.0
            row[key] = v
        rows.append({FeatureKey(*k): v for k, v in row.items()})
        jrows.append({jtel.FeatureKey(*k): v for k, v in row.items()})
    breach = [r >= shift and rng.random() < 0.9 for r in range(n_req)]
    times = [0.5 * r for r in range(n_req)]
    for col in ([r.get(FeatureKey(*keys[0]), np.nan) for r in rows],):
        assert plain(detect_regimes(col)) == plain(jtel.detect_regimes(col))
    tp = candidate_predicates(BreachDataset(rows, breach, times))
    jp = jtel.candidate_predicates(jtel.BreachDataset(jrows, breach, times))
    assert plain(tp) == plain(jp)
    for kw in ({}, {"max_exact": 0, "seed": seed}, {"max_exact": 2}):
        assert explain_breaches(rows, breach, times, **kw).to_json() == \
            jtel.explain_breaches(jrows, breach, times, **kw).to_json()
