"""The port's continuous-batching scheduler under deterministic virtual
time: tests/test_serving_sched.py on ``repro_torch.serving``, and parity
with the reference.

On the FakeClock the port's and the reference's schedulers serve the same
``Workload`` (the same requests in both packages, bit for bit) on the same
parameters to the same tokens and equal ``StepRecord``s — every field:
dispatch and run counters, virtual times and spans, batch, packed pad
tokens, cache counters — with and without ``overlap``, ``chunk_tokens``,
``churn`` and an ``autoscaler``; and ``summarize`` gives equal reports.
The port's records carry four real-clock fields the reference has not,
and on the FakeClock each of them is 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import plain
from repro import dist as jdist
from repro import serving as jserving
from repro.models import model as JM
from repro.models.model import ModelConfig as JConfig
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch import serving as tserving
from repro_torch.dist import (AdaptiveExecutor, CodedExecutor,
                              DeterministicDelay, FakeClock, FaultPlan)
from repro_torch.models.model import ModelConfig
from repro_torch.serving import (Engine, Request, ServingScheduler,
                                 LengthDist, PoissonArrivals, Workload,
                                 summarize)

L = 2
N, K_MDS = 4, 2
GEMMS = 2 * L           # ungated FFN: w_in + w_out per layer
PIECE = 0.01            # uniform virtual piece round-trip
MASTER = 0.001          # per-model-call master cost
MAX_SEQ = 16


def _cfg(scheme=None, k=K_MDS, coded=True):
    kw = dict(coded_n=N, coded_k=k, coded_scheme=scheme) if coded else {}
    return ModelConfig(name="tiny", n_layers=L, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab=64, gated=False,
                       dtype=torch.float32, **kw)


def _executor(straggler=None):
    return CodedExecutor(
        N, clock=FakeClock(), delay_model=DeterministicDelay(PIECE),
        fault_plan=FaultPlan(straggler=straggler or {}))


def _call_dt(piece_s, runs=GEMMS):
    """Replicate the scheduler's per-call accumulation bit-for-bit."""
    dt = MASTER
    for _ in range(runs):
        dt += piece_s
    return dt


def _reqs(n, prompt_len=4, max_new=3, arrivals=None):
    out = []
    for i in range(n):
        prompt = (np.arange(prompt_len, dtype=np.int32) + 3 * i) % 64
        out.append(Request(i, prompt.astype(np.int32), max_new=max_new,
                           arrival_s=0.0 if arrivals is None else arrivals[i]))
    return out


# ---------------------------------------------------------------------------
# exactness: continuous batching generates the same tokens
# ---------------------------------------------------------------------------

class TestTokenEquivalence:
    def test_mixed_depth_lanes_match_closed_batch(self):
        # different prompt lengths admitted together -> the running batch
        # immediately holds lanes at different positions
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        reqs = [Request(0, np.arange(4, dtype=np.int32), max_new=4),
                Request(1, np.arange(7, dtype=np.int32) % 5, max_new=3),
                Request(2, np.arange(5, dtype=np.int32) + 9, max_new=5),
                Request(3, np.arange(4, dtype=np.int32) + 2, max_new=2)]
        ref = {}
        for r in reqs:
            (c,) = eng.generate([dataclasses.replace(r)])
            ref[r.rid] = c.tokens.tolist()
        res = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4).serve(reqs)
        assert len(res.completions) == 4
        for c in res.completions:
            assert c.tokens.tolist() == ref[c.rid], c.rid

    def test_staggered_joins_on_virtual_pool(self):
        # requests arrive mid-decode of earlier lanes (uncoded scheme: the
        # coded path is numerically exact, so tokens must match the
        # per-request reference even as lanes join and leave)
        with _executor() as ex:
            eng = Engine(_cfg("uncoded", k=N), seed=0, executor=ex, device="cpu")
            arrivals = [0.0, 0.0, 0.1, 0.15, 0.3, 0.3]
            reqs = _reqs(6, prompt_len=4, max_new=4, arrivals=arrivals)
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     master_call_s=MASTER)
            res = sched.serve(reqs)
        eng_ref = Engine(_cfg(coded=False), seed=0, device="cpu")
        for c in res.completions:
            (ref,) = eng_ref.generate([dataclasses.replace(reqs[c.rid])])
            assert c.tokens.tolist() == ref.tokens.tolist(), c.rid
        # arrivals actually staggered the admissions
        admits = {r.rid: r.admit_s for r in res.records}
        assert admits[4] >= 0.3 and admits[0] == 0.0


# ---------------------------------------------------------------------------
# pinned virtual-time SLOs: mds ignores the straggler, uncoded eats it
# ---------------------------------------------------------------------------

class TestPinnedVirtualTime:
    def _serve(self, scheme, k, straggler=None, n_req=5):
        with _executor(straggler) as ex:
            eng = Engine(_cfg(scheme, k=k), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=8,
                                     master_call_s=MASTER)
            return sched.serve(_reqs(n_req, prompt_len=4, max_new=3))

    def test_mds_timeline_pinned(self):
        # 5 requests at t=0, max_new=3: step 0 = prefill + decode, step 1 =
        # decode + retire.  Every model call costs MASTER + GEMMS pieces.
        res = self._serve("mds", K_MDS)
        call = _call_dt(PIECE)
        t1 = call + call          # end of step 0
        t_end = t1 + call         # end of step 1
        assert res.t_end == t_end
        assert [s.t_end for s in res.steps] == [t1, t_end]
        for r in res.records:
            assert r.first_token_s == call
            assert r.done_s == t_end
            assert r.n_tokens == 3

    def test_mds_cancels_straggler_exactly(self):
        # k=2 of 4: the 10x worker never holds the k-th arrival back, so
        # the timeline is IDENTICAL to the fault-free pin
        res = self._serve("mds", K_MDS, straggler={3: 10.0})
        assert res.t_end == 3 * _call_dt(PIECE)

    def test_uncoded_pays_straggler_exactly(self):
        # all 4 pieces needed: every run completes at the straggler's pace
        res = self._serve("uncoded", N, straggler={3: 10.0})
        call = _call_dt(10.0 * PIECE)
        assert res.t_end == 3 * call
        assert all(r.ttft_s == call for r in res.records)

    def test_coded_beats_uncoded_under_straggler(self):
        coded = self._serve("mds", K_MDS, straggler={3: 10.0})
        uncoded = self._serve("uncoded", N, straggler={3: 10.0})
        s_c = summarize(coded, deadline_s=0.2)
        s_u = summarize(uncoded, deadline_s=0.2)
        assert s_c["ttft_s"]["p99"] < s_u["ttft_s"]["p99"]
        assert s_c["slo_attainment"] == 1.0
        assert s_u["slo_attainment"] == 0.0

    def test_summary_pinned(self):
        res = self._serve("mds", K_MDS)
        call = _call_dt(PIECE)
        s = summarize(res, deadline_s=0.2)
        assert s["requests"] == 5 and s["tokens"] == 15
        assert s["ttft_s"]["p99"] == call
        assert s["e2e_s"]["p50"] == 3 * call
        assert s["goodput_rps"] == pytest.approx(5 / (3 * call))
        assert s["queue_depth"]["max"] == 0
        assert s["batch_occupancy"] == {"mean": 5.0, "max": 5}

    def test_poisson_replay_pinned(self):
        # open-loop Poisson arrivals on the virtual timeline: the whole
        # run is a pure function of the seeds — identical twice over, and
        # the queue actually builds at this offered rate
        wl = Workload(PoissonArrivals(40.0), LengthDist.fixed(4),
                      LengthDist.fixed(3), vocab=64, seed=7)
        reqs = wl.generate(12)
        a = self._poisson_run(reqs)
        b = self._poisson_run(reqs)
        assert a.t_end == b.t_end
        assert [c.tokens.tolist() for c in a.completions] == \
               [c.tokens.tolist() for c in b.completions]
        sa, sb = summarize(a, deadline_s=0.5), summarize(b, deadline_s=0.5)
        assert sa["ttft_s"] == sb["ttft_s"]
        assert sa["goodput_rps"] == sb["goodput_rps"]
        # pinned against drift: every model call costs MASTER + 4 pieces,
        # so any TTFT is arrival-offset + a whole number of calls
        call = _call_dt(PIECE)
        for r in a.records:
            steps_waited = round((r.first_token_s - r.arrival_s) / call, 6)
            assert steps_waited > 0

    @staticmethod
    def _poisson_run(reqs, max_batch=4):
        with _executor() as ex:
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ,
                                     max_batch=max_batch,
                                     master_call_s=MASTER)
            return sched.serve([dataclasses.replace(r) for r in reqs])


# ---------------------------------------------------------------------------
# the batched-dispatch invariant, on real pool counter deltas
# ---------------------------------------------------------------------------

class TestBatchedDispatch:
    def _steps(self, n_req):
        with _executor() as ex:
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=8,
                                     master_call_s=MASTER)
            return sched.serve(_reqs(n_req, prompt_len=4, max_new=4)).steps

    def test_pieces_equal_runs_times_n(self):
        for s in self._steps(5):
            assert s.dispatches == s.runs * N

    def test_decode_dispatch_independent_of_batch(self):
        # B=2 and B=7 co-scheduled lanes: decode steps issue the SAME
        # n-piece dispatch per GEMM — n per GEMM, never B*n
        for n_req in (2, 7):
            decode_steps = [s for s in self._steps(n_req) if s.admitted == 0]
            assert decode_steps, "expected decode-only steps"
            for s in decode_steps:
                assert s.batch >= K_MDS  # the stacked batch reaches the pool
                assert s.runs == GEMMS
                assert s.dispatches == GEMMS * N

    def test_co_admission_shares_one_prefill_dispatch(self):
        # 5 equal-length requests admitted in one step: ONE prefill group,
        # GEMMS runs — versus 5*GEMMS had they been prefilled per-request
        steps = self._steps(5)
        assert steps[0].admitted == 5
        assert steps[0].prefill_runs == GEMMS
        assert steps[0].prefill_dispatches == GEMMS * N

    def test_serial_baseline_pays_per_request(self):
        # max_batch=1 is per-request serving: every request prefills alone
        with _executor() as ex:
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=1,
                                     master_call_s=MASTER)
            res = sched.serve(_reqs(5, prompt_len=4, max_new=4))
        serial_prefill = sum(s.prefill_dispatches for s in res.steps)
        batched_prefill = sum(s.prefill_dispatches for s in self._steps(5))
        assert serial_prefill == 5 * GEMMS * N
        assert batched_prefill == GEMMS * N
        assert batched_prefill < serial_prefill

    def test_single_lane_decode_stays_on_master(self):
        # B=1 < k: the decode GEMM cannot even be coded — batching is what
        # buys decode-time straggler protection
        steps = self._steps(1)
        decode_steps = [s for s in steps if s.admitted == 0]
        assert decode_steps
        for s in decode_steps:
            assert s.runs == 0 and s.dispatches == 0


# ---------------------------------------------------------------------------
# policies, admission, lifecycle
# ---------------------------------------------------------------------------

class TestSchedulerPolicy:
    def test_shortest_prompt_admits_short_first(self):
        # one lane of room, two queued: SPT picks the shorter prompt even
        # though the longer arrived first
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        reqs = [Request(0, np.arange(8, dtype=np.int32), 2, arrival_s=0.0),
                Request(1, np.arange(4, dtype=np.int32), 2, arrival_s=0.0)]
        res = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=1,
                               policy="shortest_prompt").serve(reqs)
        admits = {r.rid: r.admit_s for r in res.records}
        assert admits[1] < admits[0]

    def test_fcfs_respects_arrival_order(self):
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        reqs = [Request(0, np.arange(8, dtype=np.int32), 2, arrival_s=0.0),
                Request(1, np.arange(4, dtype=np.int32), 2, arrival_s=0.0)]
        res = ServingScheduler(eng, max_seq=MAX_SEQ,
                               max_batch=1).serve(reqs)
        admits = {r.rid: r.admit_s for r in res.records}
        assert admits[0] < admits[1]

    def test_eos_retires_lane_early(self):
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        reqs = _reqs(2, prompt_len=4, max_new=6)
        probe = ServingScheduler(eng, max_seq=MAX_SEQ,
                                 max_batch=2).serve(list(reqs))
        eos = int(probe.completions[0].tokens[0])
        res = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=2,
                               eos_id=eos).serve(_reqs(2, prompt_len=4,
                                                       max_new=6))
        rec0 = next(r for r in res.records if r.rid == 0)
        assert rec0.n_tokens < 6  # stopped at EOS, not max_new

    def test_validation(self):
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        with pytest.raises(ValueError, match="policy"):
            ServingScheduler(eng, max_seq=MAX_SEQ, policy="lifo")
        with pytest.raises(ValueError, match="max_batch"):
            ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=0)
        sched = ServingScheduler(eng, max_seq=8)
        with pytest.raises(ValueError, match="max_seq"):
            sched.serve(_reqs(1, prompt_len=6, max_new=4))
        with pytest.raises(ValueError, match="max_new"):
            sched.serve([Request(0, np.arange(4, dtype=np.int32),
                                 max_new=0)])

    def test_duplicate_rid_rejected(self):
        eng = Engine(_cfg(coded=False), seed=0, device="cpu")
        reqs = [Request(0, np.arange(4, dtype=np.int32), 2),
                Request(0, np.arange(4, dtype=np.int32) + 1, 2)]
        with pytest.raises(ValueError, match="duplicate rid"):
            ServingScheduler(eng, max_seq=MAX_SEQ).serve(reqs)

    def test_pool_scripting_restored_after_serve(self):
        # _arm_step mutates the pool's FaultPlan per step; a reused pool
        # must come back unscripted or the next arm inherits the drift
        from repro_torch.dist import StragglerDrift

        with _executor() as ex:
            base_plan, base_delay = ex.pool.fault_plan, ex.pool.delay_model
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex, device="cpu")
            drift = StragglerDrift(((0, FaultPlan(straggler={3: 10.0})),))
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     master_call_s=MASTER,
                                     fault_drift=drift, delay_seed_stride=1)
            res = sched.serve(_reqs(3, prompt_len=4, max_new=2))
            assert res.t_end > 0.0
            assert ex.pool.fault_plan is base_plan
            assert ex.pool.delay_model is base_delay

    def test_queue_wait_is_accounted_from_arrival(self):
        # max_batch=1 under simultaneous arrivals: the second request's
        # TTFT includes the first one's whole service time
        with _executor() as ex:
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=1,
                                     master_call_s=MASTER)
            res = sched.serve(_reqs(2, prompt_len=4, max_new=2))
        r0, r1 = res.records
        assert r1.admit_s >= r0.done_s
        assert r1.ttft_s > r0.e2e_s


# ---------------------------------------------------------------------------
# adaptive integration: profiles keep feeding from batched pieces
# ---------------------------------------------------------------------------

class TestAdaptiveFeeding:
    def test_planner_observes_batched_runs(self):
        ex = AdaptiveExecutor(N, clock=FakeClock(),
                              delay_model=DeterministicDelay(PIECE),
                              probe_every=4)
        with ex:
            eng = Engine(_cfg("mds", k=K_MDS), seed=0, executor=ex,
                         adaptive=True, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=8,
                                     master_call_s=MASTER)
            sched.serve(_reqs(6, prompt_len=4, max_new=4))
        bank = ex.planner.bank
        # every worker's profile saw samples from the co-batched pieces
        assert set(bank.profiles) == set(range(N))
        assert all(len(p.window_samples()) > 0
                   for p in bank.profiles.values())


# ---------------------------------------------------------------------------
# parity with the reference's scheduler on the FakeClock
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", n_layers=L, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, gated=False)


@pytest.fixture(scope="module")
def params():
    """The reference's parameters and the port's copy of them."""
    jp = JM.init_params(JConfig(**TINY, dtype=jnp.float32),
                        jax.random.PRNGKey(11))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu")


def _workload(mod):
    return mod.Workload(mod.PoissonArrivals(40.0), mod.LengthDist((4, 6, 7)),
                        mod.LengthDist((2, 3, 4)), vocab=64, seed=7)


# (label, scheduler kwargs, needs an elastic pool)
VARIANTS = [
    ("plain", {}, False),
    ("overlap", dict(overlap=True), False),
    ("chunked", dict(chunk_tokens=3), False),
    ("prefix", dict(prefix=True), False),
    ("churn", dict(churn=True), True),
    ("autoscaler", dict(autoscaler=True, autoscale_redundancy=True), True),
]


# the port's StepRecord fields measured on the host's clock alone
REAL_CLOCK_ZERO = dict(wait_s=0.0, sched_s=0.0, prefill_calls=0,
                       prefill_tokens=0)


def _serve(mod, cfg, params, variant, elastic, device_kw):
    ex = mod.CodedExecutor(
        N, clock=mod.FakeClock(), delay_model=mod.DeterministicDelay(PIECE),
        fault_plan=mod.FaultPlan(straggler={3: 10.0}), timeout_s=30.0,
        elastic=elastic)
    kw = dict(variant)
    try:
        eng = mod_engine(mod)(cfg, params=params, executor=ex, **device_kw)
        if kw.pop("prefix", False):
            kw["prefix_cache"] = mod_serving(mod).PrefixCache(block=2)
        if kw.pop("churn", False):
            kw["churn"] = mod.ChurnSchedule((
                mod.ChurnEvent(0.05, "remove", 3),
                mod.ChurnEvent(0.12, "join")))
        if kw.pop("autoscaler", False):
            kw["autoscaler"] = mod.Autoscaler(ex.pool, min_workers=3,
                                              max_workers=5,
                                              target_queue=1.0)
        sched = mod_serving(mod).ServingScheduler(
            eng, max_seq=MAX_SEQ, max_batch=4, master_call_s=MASTER, **kw)
        reqs = _workload(mod_serving(mod)).generate(10)
        return sched.serve(reqs)
    finally:
        ex.close()


def mod_engine(mod):
    return jserving.Engine if mod is jdist else tserving.Engine


def mod_serving(mod):
    return jserving if mod is jdist else tserving


@pytest.mark.parametrize("label,variant,elastic", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_scheduler_equals_the_reference(params, label, variant, elastic):
    jp, tp = params
    coded = dict(coded_n=N, coded_k=K_MDS, coded_scheme="mds")
    want = _serve(jdist, JConfig(**TINY, dtype=jnp.float32, **coded), jp,
                  variant, elastic, {})
    got = _serve(tdist, ModelConfig(**TINY, dtype=torch.float32, **coded),
                 tp, variant, elastic, {"device": "cpu"})
    assert {c.rid: c.tokens.tolist() for c in got.completions} == \
        {c.rid: np.asarray(c.tokens).tolist() for c in want.completions}
    assert plain(got.steps) == [dict(s, **REAL_CLOCK_ZERO)
                                for s in plain(want.steps)]
    assert plain(got.records) == plain(want.records)
    assert got.t_end == want.t_end
    assert plain(got.membership) == plain(want.membership)
    assert plain(got.replans) == plain(want.replans)
    assert sum(s.runs for s in got.steps) > 0
    if label in ("churn", "autoscaler"):
        assert got.membership  # the fleet did change
    for kw in ({}, dict(deadline_s=0.3, ttft_deadline_s=0.1, epoch_s=0.2,
                        scenario="server")):
        assert plain(tserving.summarize(got, **kw)) == \
            plain(jserving.summarize(want, **kw))
