"""The port's adaptive loop (``dist/adaptive.py``): telemetry -> fit ->
re-plan, and ``Engine(adaptive=True)``.

Mirrors tests/test_adaptive.py on ``repro_torch`` (all eight of its tests),
then holds the port to the reference: the same synthetic telemetry gives
both planners the same plans, fits, speeds and layer scales; an
``AdaptiveExecutor`` on the same FakeClock fleet makes the same probes,
assignments and subsets run for run; and ``Engine(adaptive=True)`` on the
reference's parameters serves the same tokens through the same sequence of
(n, k, assignment) per coded GEMM.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import plain
from repro import configs as jconfigs
from repro import dist as jdist
from repro.core import latency as jlat
from repro.core import splitting as jsplit
from repro.core.planner import k_circ_remainder_aware as j_k_circ
from repro.core.schemes import get_scheme as jget_scheme
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.core import latency as tlat
from repro_torch.core import splitting as tsplit
from repro_torch.core.latency import SystemParams, phase_sizes
from repro_torch.core.planner import k_circ_remainder_aware
from repro_torch.core.schemes import get_scheme
from repro_torch.core.splitting import ConvSpec
from repro_torch.dist import AdaptivePlanner
from repro_torch.models.model import ModelConfig
from repro_torch.serving import Engine, Request

SPEC = ConvSpec(c_in=16, c_out=16, h_in=32, w_in=34, kernel=3)
N = 8


def _report(dist, timings):
    return dist.RunReport(0.0, 0.0, [], [], [], [], [], {}, timings=timings)


def _feed_synthetic(planner, prior, *, requests, slow=None, rng=None,
                    k=None, dist=tdist, lat=tlat, spec=SPEC, k_circ=None):
    """Feed per-piece round-trips sampled from the prior's true phase
    distributions; ``slow`` maps worker -> duration multiplier."""
    rng = rng or np.random.default_rng(0)
    slow = slow or {}
    k = k or (k_circ or k_circ_remainder_aware)(spec, N, prior)
    sizes = lat.phase_sizes(spec, N, k)
    for _ in range(requests):
        timings = []
        for w in range(N):
            t = float(prior.rec.scaled(sizes.n_rec).sample(rng)
                      + prior.cmp.scaled(sizes.n_cmp).sample(rng)
                      + prior.sen.scaled(sizes.n_sen).sample(rng))
            t *= slow.get(w, 1.0)
            timings.append(dist.PieceTiming(w, w, 0.0, t, t))
        planner.observe_report(_report(dist, timings), sizes)
    return sizes


# -- mirror of tests/test_adaptive.py ----------------------------------------

class TestAdaptivePlanner:
    def test_serves_prior_until_ready(self):
        prior = SystemParams()
        pl = AdaptivePlanner(prior, min_samples=8)
        plan = pl.plan(SPEC, N, N)
        assert not plan.from_telemetry
        assert plan.params == prior
        assert plan.assignment is None
        assert plan.k == k_circ_remainder_aware(SPEC, N, prior)

    def test_stationary_telemetry_converges_to_static_plan(self):
        prior = SystemParams()
        pl = AdaptivePlanner(prior, window=64, min_samples=8)
        _feed_synthetic(pl, prior, requests=40)
        plan = pl.plan(SPEC, N, N)
        assert plan.from_telemetry
        assert plan.k == k_circ_remainder_aware(SPEC, N, prior)
        assert max(plan.assignment) - min(plan.assignment) <= 1
        ph = pl.params_hat()
        assert abs(ph.theta_cmp / prior.theta_cmp - 1.0) < 0.25
        assert abs(prior.mu_cmp / ph.mu_cmp - 1.0) < 0.25

    def test_straggler_starved_of_pieces(self):
        prior = SystemParams()
        pl = AdaptivePlanner(prior, window=32, min_samples=8)
        _feed_synthetic(pl, prior, requests=16)
        _feed_synthetic(pl, prior, requests=40, slow={0: 8.0},
                        rng=np.random.default_rng(1))
        plan = pl.plan(SPEC, N, N)
        fair = N // N
        assert plan.assignment[0] < fair or plan.assignment[0] == 0
        assert plan.assignment[0] == min(plan.assignment)
        assert sum(plan.assignment) == N

    def test_fleetwide_slowdown_recalibrates_params(self):
        prior = SystemParams()
        pl = AdaptivePlanner(prior, window=64, min_samples=8)
        _feed_synthetic(pl, prior, requests=40,
                        slow={w: 2.0 for w in range(N)})
        ph = pl.params_hat()
        mean_scale = (ph.theta_cmp / prior.theta_cmp
                      + prior.mu_cmp / ph.mu_cmp) / 2.0
        assert 1.5 < mean_scale < 2.5
        assert ph.mu_m == prior.mu_m

    def test_fixed_k_only_adapts_allocation(self):
        prior = SystemParams()
        pl = AdaptivePlanner(prior, window=32, min_samples=8)
        _feed_synthetic(pl, prior, requests=20, slow={0: 8.0})
        plan = pl.plan(SPEC, N, N, fixed_k=3)
        assert plan.k == 3
        assert plan.assignment[0] == min(plan.assignment)


def _tiny(mod, dtype):
    return mod.ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                           n_kv_heads=2, d_ff=64, vocab=128, dtype=dtype)


class TestAdaptiveExecutor:
    def test_observes_runs_and_reallocates(self):
        scheme = get_scheme("mds").make(4, 2)
        sizes = phase_sizes(ConvSpec(4, 4, 8, 10, 3), 4, 2)
        with tdist.AdaptiveExecutor(
                4, prior=SystemParams(), probe_every=4,
                clock=tdist.FakeClock(),
                delay_model=tdist.DeterministicDelay([1.0, 1.0, 1.0, 6.0])
        ) as ex:
            ex.planner.bank.min_samples = 2
            for _ in range(10):
                out = ex.run(scheme,
                             [lambda i=i: torch.full((2, 2), float(i))
                              for i in range(4)],
                             sizes=sizes)
                assert isinstance(out, torch.Tensor)
            counts = [0, 0, 0, 0]
            for w in ex.last_report.assignment.values():
                counts[w] += 1
            assert counts[3] == 0, counts
            assert ex.planner.bank.profiles[3].n_observed >= 2
        assert ex.planner.ready

    def test_engine_adaptive_requires_executor(self):
        cfg = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                          n_kv_heads=2, d_ff=64, vocab=128,
                          dtype=torch.float32)
        with pytest.raises(ValueError, match="adaptive"):
            Engine(cfg, coded=(4, 2), scheme="mds", adaptive=True,
                   device="cpu")

    def test_engine_adaptive_serving_end_to_end(self):
        cfg = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                          n_kv_heads=2, d_ff=64, vocab=128,
                          dtype=torch.float32)
        reqs = [Request(i, np.arange(6, dtype=np.int32), max_new=2)
                for i in range(6)]
        ref = Engine(cfg, coded=(4, 2), scheme="mds", seed=0,
                     device="cpu").generate(reqs)
        ex = tdist.CodedExecutor(
            4, clock=tdist.FakeClock(),
            delay_model=tdist.DeterministicDelay([1., 1., 1., 6.]))
        eng = Engine(cfg, coded=(4, 2), scheme="mds", seed=0, executor=ex,
                     adaptive=True, device="cpu")
        eng.executor.probe_every = 3
        eng.executor.planner.bank.min_samples = 4
        out = eng.generate(reqs)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert eng.executor.planner.ready
        counts = [0, 0, 0, 0]
        for w in eng.executor.last_report.assignment.values():
            counts[w] += 1
        assert counts[3] == min(counts), counts
        ex.close()


# -- the port against the reference ------------------------------------------

def _spec(mod, s):
    return mod.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                        kernel=s[4])


PLAN_CASES = [  # (spec, requests, slow, window, min_samples)
    ((16, 16, 32, 34, 3), 40, {}, 64, 8),
    ((16, 16, 32, 34, 3), 30, {0: 8.0}, 32, 8),
    ((64, 64, 28, 32, 3), 25, {w: 2.0 for w in range(N)}, 64, 4),
    ((2048, 8192, 1, 4096, 1), 12, {3: 50.0, 5: 3.0}, 16, 4),
    ((2048, 8192, 1, 8, 1), 6, {2: 6.0}, 8, 2),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=range(len(PLAN_CASES)))
def test_planner_equal_the_reference(case):
    s, requests, slow, window, min_samples = case
    tp, jp = tlat.SystemParams(), jlat.SystemParams()
    tpl = tdist.AdaptivePlanner(tp, window=window, min_samples=min_samples)
    jpl = jdist.AdaptivePlanner(jp, window=window, min_samples=min_samples)
    ts, js = _spec(tsplit, s), _spec(jsplit, s)
    # before any telemetry, then after each batch of requests
    for phase in range(3):
        assert tpl.ready == jpl.ready
        assert plain(tpl.params_hat()) == plain(jpl.params_hat())
        assert tpl.speeds(N + 2) == jpl.speeds(N + 2)
        assert tpl.layer_scales(range(3)) == jpl.layer_scales(range(3))
        for n_pieces, n_workers, kw in ((N, N, {}), (10, N, {}),
                                        (N, N, {"fixed_k": 3}),
                                        (N, 0, {"workers": [1, 4, 6]}),
                                        (12, N, {"workers": []})):
            a = tpl.plan(ts, n_pieces, n_workers, **kw)
            b = jpl.plan(js, n_pieces, n_workers, **kw)
            assert (a.k, a.n_pieces, a.assignment, a.from_telemetry) == \
                (b.k, b.n_pieces, b.assignment, b.from_telemetry), kw
            assert plain(a.params) == plain(b.params)
        _feed_synthetic(tpl, tp, requests=requests, slow=slow,
                        rng=np.random.default_rng(phase), spec=ts)
        _feed_synthetic(jpl, jp, requests=requests, slow=slow,
                        rng=np.random.default_rng(phase), spec=js,
                        dist=jdist, lat=jlat, k_circ=j_k_circ)
    tpl.reset_at(float(requests))
    jpl.reset_at(float(requests))
    assert plain(tpl.params_hat()) == plain(jpl.params_hat())


def test_planner_layer_profiles_and_replan_equal_the_reference():
    """Per-stage telemetry: per-layer profiles, their scales, a reset, and
    ``replan_segments`` re-cutting a chain on them."""
    from repro.core.netplan import LayerInfo as JLI
    from repro_torch.core.netplan import LayerInfo as TLI

    def chain(mod, LI):
        out, size = [], 16
        for j in range(5):
            sp = mod.ConvSpec(c_in=3 if j == 0 else 16, c_out=16, h_in=size,
                              w_in=size, kernel=3, stride=1)
            out.append(LI(f"conv{j}", sp, True, act=None, pad=0))
            size = sp.w_out
        return tuple(out)

    tl, jl = chain(tsplit, TLI), chain(jsplit, JLI)
    tp, jp = tlat.SystemParams(), jlat.SystemParams()
    tpl = tdist.AdaptivePlanner(tp, min_samples=3)
    jpl = jdist.AdaptivePlanner(jp, min_samples=3)
    # no per-layer evidence yet: the static compile on params_hat
    assert tpl.replan_segments(tl, 10).describe() == \
        jpl.replan_segments(jl, 10).describe()
    rng = np.random.default_rng(4)
    sizes_t = [tlat.phase_sizes(li.spec, 10, 6) for li in tl[1:4]]
    sizes_j = [jlat.phase_sizes(li.spec, 10, 6) for li in jl[1:4]]
    for r in range(12):
        stages = [[float(rng.exponential(1.0) + (6.0 if (r >= 6 and j == 1)
                                                 else 1.0))
                   for j in range(3)] for _ in range(10)]
        for pl, dist, sizes in ((tpl, tdist, sizes_t), (jpl, jdist, sizes_j)):
            timings = [dist.PieceTiming(w, w, 0.0, sum(st), sum(st),
                                        stages=tuple(st))
                       for w, st in enumerate(stages)]
            pl.observe_report(_report(dist, timings), sizes, at=float(r),
                              layer_ids=[1, 2, 3])
    assert tpl.layer_scales(range(5)) == jpl.layer_scales(range(5))
    assert tpl.speeds(10) == jpl.speeds(10)
    tpl.reset_at(6.0)
    jpl.reset_at(6.0)
    assert tpl.layer_scales(range(5)) == jpl.layer_scales(range(5))
    assert plain(tpl.params_hat()) == plain(jpl.params_hat())
    assert tpl.replan_segments(tl, 10).describe() == \
        jpl.replan_segments(jl, 10).describe()
    with pytest.raises(ValueError, match="layer_ids"):
        tpl.observe_report(_report(tdist, []), sizes_t, layer_ids=[1])


def _executor_runs(dist, scheme_mod, piece):
    scheme = scheme_mod("mds").make(4, 2)
    lat = tlat if dist is tdist else jlat
    sp = (tsplit if dist is tdist else jsplit).ConvSpec(4, 4, 8, 10, 3)
    sizes = lat.phase_sizes(sp, 4, 2)
    runs = []
    with dist.AdaptiveExecutor(
            4, prior=lat.SystemParams(), probe_every=4,
            clock=dist.FakeClock(),
            delay_model=dist.DeterministicDelay([1.0, 1.0, 1.0, 6.0])) as ex:
        ex.planner.bank.min_samples = 2
        for _ in range(10):
            out = ex.run(scheme, [lambda i=i: piece(i) for i in range(4)],
                         sizes=sizes)
            r = ex.last_report
            runs.append((ex.last_was_probe, sorted(r.assignment.items()),
                         r.subset, r.t_complete,
                         [plain(t) for t in r.timings],
                         np.asarray(out).tolist()))
        runs.append(ex.planner.speeds(4))
    return runs


def test_executor_runs_equal_the_reference():
    got = _executor_runs(tdist, get_scheme,
                         lambda i: torch.full((2, 2), float(i)))
    want = _executor_runs(jdist, jget_scheme,
                          lambda i: jnp.full((2, 2), float(i)))
    assert got == want
    assert [r[0] for r in got[:-1]] == [False, False, False, True] * 2 + \
        [False, False]


def _serve_pair(jc, tc, jp, tp, reqs, n, k, delays):
    """Serve ``reqs`` adaptively on both packages: tokens and, per coded
    GEMM, (n, k, assignment) as ``plan_matmul`` returned them and the
    run's subset."""
    out = {}
    for name, dist, E, R, cfg, params, kw in (
            ("port", tdist, Engine, Request, tc, tp, {"device": "cpu"}),
            ("ref", jdist, JEngine, JRequest, jc, jp, {})):
        ex = dist.CodedExecutor(n, clock=dist.FakeClock(),
                                delay_model=dist.DeterministicDelay(delays))
        eng = E(cfg, params=params, coded=(n, k), scheme="mds", executor=ex,
                adaptive=True, **kw)
        ad = eng.executor
        ad.probe_every = 3
        ad.planner.bank.min_samples = 4
        seq = []
        plan_matmul = ad.plan_matmul

        def recording(*a, _pm=plan_matmul, _seq=seq):
            got = _pm(*a)
            _seq.append([a[2], got[0], got[1],
                         None if got[2] is None else list(got[2])])
            return got

        ad.plan_matmul = recording
        ad.on_report = lambda r, _seq=seq: _seq[-1].append(
            (list(r.subset), r.t_complete))
        try:
            res = eng.generate([R(q.rid, q.prompt, max_new=q.max_new)
                                for q in reqs])
        finally:
            ex.close()
        out[name] = ([c.tokens.tolist() for c in res], seq,
                     ad.planner.ready)
    return out


def test_engine_adaptive_tiny_equals_the_reference():
    jc = _tiny(JM, jnp.float32)
    tc = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=128, dtype=torch.float32)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    reqs = [Request(i, np.arange(6, dtype=np.int32) + i, max_new=3)
            for i in range(6)]
    got = _serve_pair(jc, tc, jp, tp, reqs, 4, 2, [1., 1., 1., 6.])
    assert got["port"] == got["ref"]
    assert got["port"][2] and len(got["port"][1]) > 0


def test_engine_adaptive_zamba2_smoke_equals_the_reference():
    arch = "zamba2-1.2b"
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(1))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, tc.vocab, 8, dtype=np.int32),
                    max_new=3) for i in range(6)]
    delays = [1.0, 1.0, 1.2, 1.0, 1.0, 9.0]
    got = _serve_pair(jc, tc, jp, tp, reqs, 6, 3, delays)
    assert got["port"][1] == got["ref"][1]
    assert got["port"][0] == got["ref"][0]
    seq = got["port"][1]
    assert got["port"][2] and len(seq) >= 12
    # the planner re-solved k and re-allocated pieces once its profiles
    # were ready: the 9x worker 5 was starved
    assert any(row[2] not in (None, 3) for row in seq)
    assert seq[-1][3] is not None and seq[-1][3][5] == 0


def test_engine_adaptive_errors_match_the_reference():
    tc = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=128, dtype=torch.float32)
    jc = _tiny(JM, jnp.float32)
    tparams = Engine(tc, seed=0, device="cpu").params
    cases = []
    for name, dist, E, cfg, kw in (
            ("port", tdist, Engine, tc, {"device": "cpu", "params": tparams}),
            ("ref", jdist, JEngine, jc, {})):
        kinds = []
        # no executor
        try:
            E(cfg, coded=(4, 2), scheme="mds", adaptive=True, **kw)
        except Exception as e:  # noqa: BLE001
            kinds.append(type(e).__name__)
        # the one-program backend
        try:
            E(cfg, coded=(4, 2), scheme="mds", adaptive=True,
              executor="mesh", **kw)
        except Exception as e:  # noqa: BLE001
            kinds.append(type(e).__name__)
        # a prior given beside an AdaptiveExecutor
        ad = dist.AdaptiveExecutor(4, clock=dist.FakeClock())
        try:
            E(cfg, coded=(4, 2), scheme="mds", adaptive=True, executor=ad,
              adaptive_prior=(tlat if dist is tdist else jlat).SystemParams(),
              **kw)
        except Exception as e:  # noqa: BLE001
            kinds.append(type(e).__name__)
        # an AdaptiveExecutor without a prior is taken as it is
        eng = E(cfg, coded=(4, 2), scheme="mds", adaptive=True, executor=ad,
                **kw)
        kinds.append(eng.executor is ad)
        # a plain pool is wrapped, carrying the prior
        ex = dist.CodedExecutor(4, clock=dist.FakeClock())
        prior = (tlat if dist is tdist else jlat).SystemParams(mu_cmp=1e9)
        eng = E(cfg, coded=(4, 2), scheme="mds", adaptive=True, executor=ex,
                adaptive_prior=prior, **kw)
        kinds.append((type(eng.executor).__name__,
                      eng.executor.pool is ex.pool,
                      plain(eng.executor.planner.prior)))
        ad.close()
        ex.close()
        cases.append(kinds)
    assert cases[0] == cases[1]
    assert cases[0][:3] == ["ValueError"] * 3
