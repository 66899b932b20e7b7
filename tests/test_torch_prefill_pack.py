"""Prefill packing, chunked prefill and the coded prefix cache on the port
(tests/test_prefill_pack.py on ``repro_torch``), plus parity with the JAX
reference on the same parameters (carried across through numpy):

* ``prefill(lens=)`` / ``Engine.prefill_packed``: logits within 1e-4 of
  the reference's largest, first tokens equal;
* ``prefill_resume`` / ``Engine.prefill_chunk`` over two and three chunks:
  logits and KV within 1e-4 of the one-shot prefill and of the
  reference's chunked resume;
* ``chunk_attention`` directly at 1e-5 relative;
* ``kv_prefix`` / ``cache_from_prefix``: a round trip restores the KV
  bit for bit;
* ``PrefixCache``: lookups, inserts, evictions and stats equal to the
  reference's for the same script.

The ``make_executor`` fixture here builds the port's executors:
``CodedExecutor`` on the FakeClock, or ``MeshExecutor`` with the same
fault pattern when ``REPRO_BACKEND=mesh``.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.model import ModelConfig as JConfig
from repro.serving import Engine as JEngine
from repro_torch import convert
from repro_torch.core.schemes import scheme_names
from repro_torch.dist import (Autoscaler, ChurnEvent, ChurnSchedule,
                              CodedExecutor, DeterministicDelay, FakeClock)
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.model import ModelConfig
from repro_torch.serving import (Engine, PrefixCache, Request,
                                 ServingScheduler)
from repro_torch.serving.prefix_cache import PrefixCacheStats


@pytest.fixture
def make_executor():
    """The port's counterpart of conftest's fixture of the same name."""
    from repro_torch.dist import FaultPlan, MeshExecutor

    made = []

    def make(n, dead=(), stragglers=()):
        if os.environ.get("REPRO_BACKEND", "threads") == "mesh":
            ex = MeshExecutor(dead=tuple(dead), stragglers=tuple(stragglers))
        else:
            ex = CodedExecutor(
                n, clock=FakeClock(), delay_model=DeterministicDelay(1.0),
                fault_plan=FaultPlan(
                    dead=frozenset(dead),
                    straggler={w: 50.0 for w in stragglers}))
        made.append(ex)
        return ex

    yield make
    for ex in made:
        ex.close()


L = 2
N = 4
GEMMS = 2 * L           # ungated FFN: w_in + w_out per layer
MAX_SEQ = 24
# per-scheme k: free-k codes get 2-of-4; structural-k schemes derive their
# own (replication floor(n/2), uncoded n)
K = {"mds": 2, "lt": 2, "replication": 0, "uncoded": 0}


def _cfg(scheme=None, coded=True, **over):
    kw = dict(coded_n=N, coded_k=K.get(scheme, 2),
              coded_scheme=scheme) if coded else {}
    kw.update(over)
    return ModelConfig(name="tiny", n_layers=L, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab=64, gated=False,
                       dtype=torch.float32, **kw)


def _mixed_reqs(lengths=(4, 7, 5, 4), max_new=3, arrivals=None):
    out = []
    for i, T in enumerate(lengths):
        prompt = ((np.arange(T, dtype=np.int32) * 5 + 3 * i) % 64)
        out.append(Request(i, prompt.astype(np.int32), max_new=max_new,
                           arrival_s=0.0 if arrivals is None
                           else arrivals[i]))
    return out


def _tokens(res):
    return {c.rid: c.tokens.tolist() for c in res.completions}


def _copy(reqs):
    return [dataclasses.replace(r, prompt=r.prompt.copy()) for r in reqs]


# ---------------------------------------------------------------------------
# PrefixCache: deterministic radix semantics (no engine involved — the
# cache never interprets its stored pytrees)
# ---------------------------------------------------------------------------

class TestPrefixCacheUnit:
    @staticmethod
    def _seg(nbytes=64):
        def fn(t0, t1):
            return np.zeros(((t1 - t0), nbytes // (t1 - t0)), np.uint8)
        return fn

    def test_block_granularity(self):
        pc = PrefixCache(block=4)
        toks = list(range(10))
        added = pc.insert(toks, self._seg())
        assert added == 8          # 2 whole blocks; the 2-token tail is NOT stored
        assert pc.n_blocks == 2
        hit, segs = pc.lookup(toks)
        assert hit == 8 and len(segs) == 2

    def test_partial_tail_never_poisons_divergent_prompts(self):
        pc = PrefixCache(block=4)
        pc.insert([1, 2, 3, 4, 9, 9], self._seg())   # tail (9, 9) dropped
        hit, _ = pc.lookup([1, 2, 3, 4, 7, 7, 7, 7])
        assert hit == 4            # shared block matches; divergence is free

    def test_segment_fn_called_only_for_missing_blocks(self):
        pc = PrefixCache(block=4)
        calls = []

        def fn(t0, t1):
            calls.append((t0, t1))
            return np.zeros(4, np.uint8)

        pc.insert(list(range(8)), fn)
        assert calls == [(0, 4), (4, 8)]
        calls.clear()
        pc.insert(list(range(12)), fn)   # first 2 blocks resident
        assert calls == [(8, 12)]
        assert pc.insert(list(range(12)), fn) == 0  # pure LRU refresh
        assert calls == [(8, 12)]

    def test_trie_divergence(self):
        pc = PrefixCache(block=2)
        pc.insert([1, 2, 3, 4], self._seg())
        pc.insert([1, 2, 8, 9], self._seg())
        assert pc.n_blocks == 3    # shared root block + two divergent children
        assert pc.lookup([1, 2, 3, 4])[0] == 4
        assert pc.lookup([1, 2, 8, 9])[0] == 4
        assert pc.lookup([1, 2, 5, 5])[0] == 2

    def test_lru_by_bytes_evicts_leaf_first_deterministically(self):
        # 3 independent 64-byte roots in a 160-byte cache: inserting the
        # third overflows; the least-recently-USED (not -inserted) goes
        pc = PrefixCache(capacity_bytes=160, block=2)
        pc.insert([1, 1], self._seg(64))
        pc.insert([2, 2], self._seg(64))
        pc.lookup([1, 1])                      # touch A after B's insert
        pc.insert([3, 3], self._seg(64))       # overflow -> evict B
        assert pc.lookup([2, 2])[0] == 0
        assert pc.lookup([1, 1])[0] == 2 and pc.lookup([3, 3])[0] == 2
        assert pc.stats.evictions == 1 and pc.stats.evicted_tokens == 2
        assert pc.bytes <= 160

    def test_eviction_takes_leaves_before_parents(self):
        pc = PrefixCache(capacity_bytes=128, block=2)
        pc.insert([1, 1, 2, 2], self._seg(64))  # parent + child, 128 bytes
        pc.insert([5, 5], self._seg(64))        # overflow by 64
        # the chain's LEAF [1,1]->[2,2] is oldest-used; parent survives, so
        # the tree never strands an unreachable interior node
        assert pc.lookup([1, 1, 2, 2])[0] == 2
        assert pc.lookup([5, 5])[0] == 2

    def test_stats_and_clear(self):
        pc = PrefixCache(block=4)
        assert isinstance(pc.stats, PrefixCacheStats)
        pc.lookup([1, 2, 3, 4])
        pc.insert([1, 2, 3, 4], self._seg())
        pc.lookup([1, 2, 3, 4])
        assert pc.stats.lookups == 2
        assert pc.stats.hits == 1 and pc.stats.misses == 1
        assert pc.stats.hit_rate == 0.5
        assert pc.stats.hit_tokens == 4 and pc.stats.inserted_tokens == 4
        pc.clear()
        assert pc.n_blocks == 0 and pc.bytes == 0
        assert pc.lookup([1, 2, 3, 4])[0] == 0
        assert pc.stats.lookups == 3   # history survives clear()

    def test_validation(self):
        with pytest.raises(ValueError, match="block"):
            PrefixCache(block=0)
        with pytest.raises(ValueError, match="capacity"):
            PrefixCache(capacity_bytes=0)


# ---------------------------------------------------------------------------
# packing: one padded call == the grouped serial path, for every scheme,
# on the selected backend
# ---------------------------------------------------------------------------

class TestPackedExactness:
    @pytest.mark.parametrize("name", scheme_names())
    def test_packed_matches_grouped_per_scheme(self, name, make_executor):
        res = {}
        for packed in (False, True):
            ex = make_executor(N)
            eng = Engine(_cfg(name), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     master_call_s=1e-3, packed=packed)
            res[packed] = sched.serve(_copy(_mixed_reqs()))
        assert _tokens(res[True]) == _tokens(res[False])

    def test_packed_matches_grouped_eager(self):
        # no executor: the masked prefill against the per-length prefill
        toks = {}
        for packed in (False, True):
            eng = Engine(_cfg(coded=False), seed=0, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     packed=packed)
            toks[packed] = _tokens(sched.serve(_copy(_mixed_reqs())))
        assert toks[True] == toks[False]

    def test_one_admission_one_dispatch_per_gemm(self, make_executor):
        # 3 distinct prompt lengths admitted together: packed runs GEMMS
        # coded GEMMs total; the grouped path runs GEMMS per length.
        runs = {}
        for packed in (False, True):
            ex = make_executor(N)
            eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     master_call_s=1e-3, packed=packed)
            res = sched.serve(_copy(_mixed_reqs(lengths=(4, 7, 5))))
            runs[packed] = res.steps[0].prefill_runs
        assert runs[True] == GEMMS
        assert runs[False] == 3 * GEMMS

    def test_packed_pad_accounting(self, make_executor):
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                 master_call_s=1e-3)
        res = sched.serve(_copy(_mixed_reqs(lengths=(4, 7, 5))))
        s0 = res.steps[0]
        assert s0.packed_tokens == 16          # 4 + 7 + 5 real tokens
        assert s0.packed_pad_tokens == 3 * 7 - 16

    def test_packed_true_rejected_for_stateful_arch(self):
        # an SSM integrates padding into its state — packing would be wrong,
        # so it is refused loudly and auto-off by default
        cfg = ModelConfig(name="tiny-ssm", n_layers=1, d_model=32, n_heads=4,
                          n_kv_heads=4, d_ff=64, vocab=64, gated=False,
                          dtype=torch.float32, block="mamba")
        eng = Engine(cfg, seed=0, device="cpu")
        assert not eng.supports_packed
        with pytest.raises(ValueError, match="dense-attention"):
            ServingScheduler(eng, max_seq=MAX_SEQ, packed=True)
        sched = ServingScheduler(eng, max_seq=MAX_SEQ)  # auto-selects off
        assert not sched.packed


# ---------------------------------------------------------------------------
# chunked prefill: exact, and genuinely interleaved with decode
# ---------------------------------------------------------------------------

class TestChunkedPrefill:
    @pytest.mark.parametrize("name", scheme_names())
    def test_chunked_matches_one_shot_per_scheme(self, name, make_executor):
        reqs = _mixed_reqs(lengths=(12, 4), max_new=4)
        toks = {}
        for chunk in (0, 5):
            ex = make_executor(N)
            eng = Engine(_cfg(name), seed=0, executor=ex, device="cpu")
            sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                     master_call_s=1e-3, chunk_tokens=chunk)
            toks[chunk] = _tokens(sched.serve(_copy(reqs)))
        assert toks[5] == toks[0]

    def test_chunk_count_and_interleaving(self, make_executor):
        # a 12-token prompt at chunk_tokens=4 takes ceil(12/4)=3 steps of
        # prefill; a short prompt admitted alongside decodes DURING them
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                 master_call_s=1e-3, chunk_tokens=4)
        res = sched.serve(_copy(_mixed_reqs(lengths=(12, 4), max_new=6)))
        assert sum(s.prefill_chunks for s in res.steps) == math.ceil(12 / 4)
        # interleaving: some step both advanced the stream AND decoded
        assert any(s.prefill_chunks > 0 and s.batch > 0 for s in res.steps)
        # the stream held a batch slot but decoded nothing until its last
        # chunk: the long request's first token lands strictly after the
        # short one's
        recs = {r.rid: r for r in res.records}
        assert recs[0].first_token_s > recs[1].first_token_s

    def test_chunk_stream_bounds_step_occupancy(self, make_executor):
        # every prefill-bearing step costs at most one chunk's GEMMs per
        # stream — never the whole prompt's — so a long prompt cannot
        # monopolize a step (the TPOT-flatness mechanism)
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        sched = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                 master_call_s=1e-3, chunk_tokens=4)
        res = sched.serve(_copy(_mixed_reqs(lengths=(12,), max_new=3)))
        assert max(s.prefill_runs for s in res.steps) == GEMMS

    def test_chunking_rejects_overlap_mode(self):
        ex = CodedExecutor(N, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0))
        try:
            eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
            with pytest.raises(ValueError, match="serial"):
                ServingScheduler(eng, max_seq=MAX_SEQ, overlap=True,
                                 chunk_tokens=4)
        finally:
            ex.close()


# ---------------------------------------------------------------------------
# prefix caching in the serving loop: hits skip coded work, warm caches
# survive coding-layer events
# ---------------------------------------------------------------------------

# prompt length 9 == block 8 + 1: a replay's lookup on prompt[:-1] matches
# the whole 8-token block and leaves a ONE-token suffix — below every
# scheme's k, so a hot hit cannot reach the pool at all
HOT_LEN = 9
BLOCK = 8


def _hot_reqs(n=3, max_new=3):
    base = (np.arange(HOT_LEN, dtype=np.int32) * 7 + 1) % 64
    return [Request(i, base.copy(), max_new=max_new, arrival_s=2.0 * i)
            for i in range(n)]


class TestPrefixCacheServing:
    @pytest.mark.parametrize("name", scheme_names())
    def test_cached_matches_cold_per_scheme(self, name, make_executor):
        ex = make_executor(N)
        eng = Engine(_cfg(name), seed=0, executor=ex, device="cpu")
        cold = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                master_call_s=1e-3).serve(_copy(_hot_reqs()))
        pc = PrefixCache(block=BLOCK)
        warm = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                master_call_s=1e-3,
                                prefix_cache=pc).serve(_copy(_hot_reqs()))
        assert _tokens(warm) == _tokens(cold)
        assert pc.stats.hits > 0

    def test_hot_hit_issues_zero_pool_dispatches(self, make_executor):
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        pc = PrefixCache(block=BLOCK)
        mk = lambda: ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                      master_call_s=1e-3, prefix_cache=pc)
        first = mk().serve(_copy(_hot_reqs()))
        # request 0 prefills cold and inserts; every later identical prompt
        # hits the whole block and its 1-token suffix stays master-local
        cold_steps = [s for s in first.steps if s.packed_tokens > 0]
        assert len(cold_steps) == 1
        assert sum(s.prefix_hit_tokens for s in first.steps) == 2 * BLOCK
        for s in first.steps:
            if s.prefix_hit_tokens and not s.packed_tokens:
                assert s.prefill_dispatches == 0 and s.prefill_runs == 0
        # a fully-warm replay issues ZERO prefill dispatches end to end
        replay = mk().serve(_copy(_hot_reqs()))
        assert sum(s.prefill_dispatches for s in replay.steps) == 0
        assert sum(s.prefill_runs for s in replay.steps) == 0
        assert _tokens(replay) == _tokens(first)

    def test_warm_cache_survives_retarget_coded(self, make_executor):
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        pc = PrefixCache(block=BLOCK)
        mk = lambda: ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                      master_call_s=1e-3, prefix_cache=pc)
        first = mk().serve(_copy(_hot_reqs()))
        eng.retarget_coded(N, 3)   # redundancy re-plan: mds(4,2) -> (4,3)
        replay = mk().serve(_copy(_hot_reqs()))
        # cached KV is post-decode plaintext — the re-plan invalidated
        # nothing: full hits, zero prefill dispatches, identical tokens
        assert sum(s.prefill_dispatches for s in replay.steps) == 0
        assert _tokens(replay) == _tokens(first)

    def test_warm_cache_survives_churn_and_redundancy_autoscale(self):
        # elastic fleet + live (n, k) re-plans, threaded pool (churn needs
        # one): warm-cache serving stays exact and dispatch-free
        ex = CodedExecutor(N, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0),
                           timeout_s=30.0, elastic=True)
        try:
            eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
            pc = PrefixCache(block=BLOCK)
            cold = ServingScheduler(
                eng, max_seq=MAX_SEQ, max_batch=4, master_call_s=1e-3,
                prefix_cache=pc).serve(_copy(_hot_reqs()))
            churn = ChurnSchedule((ChurnEvent(2.0, "remove", 3),))
            auto = Autoscaler(ex.pool, min_workers=3, max_workers=4,
                              target_queue=100.0)
            warm = ServingScheduler(
                eng, max_seq=MAX_SEQ, max_batch=4, master_call_s=1e-3,
                prefix_cache=pc, churn=churn, autoscaler=auto,
                autoscale_redundancy=True).serve(_copy(_hot_reqs()))
        finally:
            ex.close()
        assert warm.replans          # the fleet change DID re-plan (n, k)
        assert sum(s.prefill_dispatches for s in warm.steps) == 0
        assert _tokens(warm) == _tokens(cold)

    def test_cache_telemetry_in_steps(self, make_executor):
        ex = make_executor(N)
        eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
        pc = PrefixCache(block=BLOCK)
        res = ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                               master_call_s=1e-3,
                               prefix_cache=pc).serve(_copy(_hot_reqs()))
        assert res.steps[-1].cache_bytes == pc.bytes > 0
        assert sum(s.prefix_hit_tokens for s in res.steps) \
            == pc.stats.hit_tokens

    def test_warm_replay_master_time_attributed(self):
        # a fully-warm replay runs ENTIRELY master-
        # local — hot-hit prefill plus B=1 decode (one token < every k)
        # never reach the pool, so every step records span_s == 0 while
        # the virtual clock still advances.  StepRecord.master_s is where
        # that time now shows up.  Threads-pinned: the accounting is
        # exact only on the virtual clock (mesh runs on wall time).
        ex = CodedExecutor(N, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0))
        try:
            eng = Engine(_cfg("mds"), seed=0, executor=ex, device="cpu")
            pc = PrefixCache(block=BLOCK)
            mk = lambda: ServingScheduler(eng, max_seq=MAX_SEQ, max_batch=4,
                                          master_call_s=1e-3,
                                          prefix_cache=pc)
            mk().serve(_copy(_hot_reqs()))
            replay = mk().serve(_copy(_hot_reqs()))
        finally:
            ex.close()
        assert sum(s.runs for s in replay.steps) == 0
        assert sum(s.prefill_dispatches for s in replay.steps) == 0
        for s in replay.steps:
            assert s.span_s == 0.0 and s.master_s > 0.0
            # with zero pool time the step's whole extent IS master time
            assert s.t_end - s.t_start == pytest.approx(s.master_s)
        # a hot-hit step books TWO calls (master-local prefill + decode)
        hot = [s for s in replay.steps if s.prefix_hit_tokens]
        assert hot
        assert all(s.master_s == pytest.approx(2e-3) for s in hot)


# ---------------------------------------------------------------------------
# parity with the reference, on the reference's parameters
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", n_layers=L, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, gated=False)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port params), f32."""
    jc = JConfig(**TINY, dtype=jnp.float32)
    tc = ModelConfig(**TINY, dtype=torch.float32)
    jp = JM.init_params(jc, jax.random.PRNGKey(7))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    return jc, jp, tc, tp


def _unstack(jc, layers):
    if isinstance(layers, dict):  # the reference stacks a homogeneous model
        return [jax.tree.map(lambda a, i=i: a[i], layers)
                for i in range(jc.n_layers)]
    return layers


def _rel(got, want, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: err {err:.3g} > {rel} * {scale:.3g}"


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, n, dtype=np.int32) for n in lengths]


def test_packed_prefill_logits_and_first_tokens_match_reference(pair):
    """Full logits at 1e-4 of the largest; first tokens equal."""
    jc, jp, tc, tp = pair
    prompts = _prompts((4, 9, 6))
    T = 9
    toks = np.zeros((3, T), np.int32)
    for j, p in enumerate(prompts):
        toks[j, : len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    jl, jcache = jax.jit(lambda p, t, ln: JM.prefill(
        jc, p, t, max_seq=16, lens=ln))(jp, jnp.asarray(toks),
                                        jnp.asarray(lens))
    tl, tcache = TM.prefill(tc, tp, torch.as_tensor(toks), max_seq=16,
                            lens=torch.as_tensor(lens))
    _rel(tl, jl, 1e-4, "packed logits")
    assert tcache["pos"].tolist() == lens.tolist()
    for i, (a, b) in enumerate(zip(tcache["layers"],
                                   _unstack(jc, jcache["layers"]))):
        for leaf in ("k", "v"):  # the real slots; padding slots are garbage
            for j, n in enumerate(lens):
                _rel(a["kv"][leaf][j, :n], np.asarray(b["kv"][leaf])[j, :n],
                     1e-4, f"layer {i} {leaf} lane {j}")
    first_t, _ = Engine(tc, params=tp, device="cpu").prefill_packed(
        prompts, 16)
    first_j, _ = JEngine(jc, params=jp).prefill_packed(prompts, 16)
    assert first_t.tolist() == np.asarray(first_j).tolist()


@pytest.mark.parametrize("cuts", [(5,), (3, 8)], ids=["2chunks", "3chunks"])
def test_prefill_resume_matches_one_shot_and_reference(pair, cuts):
    """Chunked prefill: logits after the last chunk within 1e-4 of the
    one-shot prefill's and the reference's chunked resume's; the cache
    within 1e-4 of the reference's, slot for slot."""
    jc, jp, tc, tp = pair
    prompt = _prompts((11,), seed=3)[0][None]
    one_l, one_c = TM.prefill(tc, tp, torch.as_tensor(prompt), max_seq=16)
    tcache = TM.init_cache(tc, 1, 16, device="cpu")
    jcache = JM.init_cache(jc, 1, 16)
    j_resume = jax.jit(lambda p, c, t: JM.prefill_resume(jc, p, c, t))
    bounds = (0,) + cuts + (prompt.shape[1],)
    for a, b in zip(bounds, bounds[1:]):
        chunk = prompt[:, a:b]
        tl, tcache = TM.prefill_resume(tc, tp, tcache, torch.as_tensor(chunk))
        jl, jcache = j_resume(jp, jcache, jnp.asarray(chunk))
        _rel(tl, jl, 1e-4, f"chunk [{a}, {b}) logits")
        assert int(tcache["pos"]) == int(jcache["pos"]) == b
    _rel(tl, one_l, 1e-4, "chunked vs one-shot logits")
    for i, (a, b, c) in enumerate(zip(tcache["layers"],
                                      _unstack(jc, jcache["layers"]),
                                      one_c["layers"])):
        for leaf in ("k", "v"):
            _rel(a["kv"][leaf], np.asarray(b["kv"][leaf]), 1e-4,
                 f"layer {i} {leaf} vs reference")
            _rel(a["kv"][leaf][:, :11], c["kv"][leaf][:, :11], 1e-4,
                 f"layer {i} {leaf} vs one-shot")


def test_engine_prefill_chunk_matches_reference_engine(pair):
    jc, jp, tc, tp = pair
    prompt = _prompts((10,), seed=4)[0][None]
    teng, jeng = Engine(tc, params=tp, device="cpu"), JEngine(jc, params=jp)
    tcache, jcache = teng.new_stream_cache(16), jeng.new_stream_cache(16)
    for a, b in ((0, 4), (4, 10)):
        tt, tcache = teng.prefill_chunk(tcache, prompt[:, a:b])
        jt, jcache = jeng.prefill_chunk(jcache, prompt[:, a:b])
    assert tt.tolist() == np.asarray(jt).tolist()
    with pytest.raises(ValueError, match="overruns"):
        teng.prefill_chunk(tcache, np.zeros((1, 7), np.int32))
    with pytest.raises(ValueError, match="scalar cache position"):
        TM.prefill_resume(tc, tp, {**tcache, "pos": torch.tensor([10])},
                          torch.zeros((1, 1), dtype=torch.long))


@pytest.mark.parametrize("pos0,Tc,H,K", [(0, 5, 4, 2), (7, 3, 4, 1),
                                         (12, 4, 2, 2)])
def test_chunk_attention_matches_reference(pos0, Tc, H, K):
    """1e-5 relative to the largest output."""
    rng = np.random.default_rng(pos0 + Tc)
    S, P = 16, 8
    q = rng.normal(size=(2, Tc, H, P)).astype(np.float32)
    kc = rng.normal(size=(2, S, K, P)).astype(np.float32)
    vc = rng.normal(size=(2, S, K, P)).astype(np.float32)
    got = tattn.chunk_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                torch.as_tensor(vc), torch.tensor(pos0))
    want = jattn.chunk_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(pos0))
    _rel(got, want, 1e-5, "chunk attention")
    # one token is decode attention below the ring wrap
    if Tc == 1 or pos0 + Tc <= S:
        one = tattn.chunk_attention(torch.as_tensor(q[:, :1]),
                                    torch.as_tensor(kc), torch.as_tensor(vc),
                                    pos0)
        dec = tattn.decode_attention(torch.as_tensor(q[:, :1]),
                                     torch.as_tensor(kc), torch.as_tensor(vc),
                                     torch.tensor(pos0))
        assert torch.allclose(one, dec, rtol=1e-6, atol=1e-6)


def test_kv_prefix_round_trip(pair):
    """Segments sliced out of a packed batch cache rebuild a stream cache
    whose restored slots are those bits, on the engine's device, with a
    scalar position; the segments are copies, not views of the batch."""
    _, _, tc, tp = pair
    eng = Engine(tc, params=tp, device="cpu")
    _, cache = eng.prefill_packed(_prompts((12, 9)), 16)
    segs = [eng.kv_prefix(cache, 1, t0, t0 + 4) for t0 in (0, 4)]
    leaf = segs[0][0]["kv"]["k"]
    assert leaf.shape == (1, 4, tc.n_kv_heads, tc.hd)
    assert leaf.data_ptr() != cache["layers"][0]["kv"]["k"].data_ptr()
    rebuilt = eng.cache_from_prefix(segs, 8, 16)
    assert rebuilt["pos"].dim() == 0 and int(rebuilt["pos"]) == 8
    for a, b in zip(rebuilt["layers"], cache["layers"]):
        for k in ("k", "v"):
            assert torch.equal(a["kv"][k][0, :8], b["kv"][k][1, :8])
            assert not a["kv"][k][0, 8:].any()
    # resuming the restored cache gives the one-shot prompt's next token
    prompt = _prompts((12, 9))[1]
    tok, _ = eng.prefill_chunk(rebuilt, prompt[8:][None])
    first, _ = eng.prefill_batch(prompt[None], 16)
    assert tok.tolist() == first.tolist()


def _cache_script(mod):
    """The same inserts and lookups on either package's PrefixCache: a
    trie with a shared root, an eviction under a 3-block capacity, a
    re-insert that only refreshes; segments are 8-byte numpy arrays."""
    pc = mod.PrefixCache(capacity_bytes=3 * 4 * 8, block=4)
    seg = lambda t0, t1: np.zeros(((t1 - t0), 2), np.float32)
    log = []
    for toks in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 7, 7, 7, 7],
                 [9, 9, 9, 9], [1, 2, 3, 4, 5, 6, 7, 8],
                 [2, 2, 2, 2, 2, 2, 2, 2]):
        hit, segs = pc.lookup(toks[:-1])
        added = pc.insert(toks, seg)
        log.append((hit, len(segs), added, pc.bytes, pc.n_blocks))
    return log, dataclasses.asdict(pc.stats), pc.stats.hit_rate


def test_prefix_cache_equals_the_reference():
    import repro.serving.prefix_cache as jpc
    import repro_torch.serving.prefix_cache as tpc

    assert _cache_script(tpc) == _cache_script(jpc)


def test_prefix_cache_sizes_device_tensors_without_host_copies():
    pc = PrefixCache(block=2)
    kv = [{"kv": {"k": torch.zeros(1, 2, 3, 4), "v": torch.zeros(1, 2, 3, 4,
                                                                dtype=torch.bfloat16)}}]
    pc.insert([1, 2], lambda t0, t1: kv)
    assert pc.bytes == 2 * 3 * 4 * 4 + 2 * 3 * 4 * 2
