"""Per-request latency accounting in the port's serving engine:
tests/test_engine_latency.py on ``repro_torch.serving.Engine``.

A test that reads the wall clock asserts only orderings that hold under
any load; the one that needs exact instants (an arrival stamped inside the
batch window) runs on a deterministic counter put in place of
``time.perf_counter`` by ``monkeypatch``.  The port's greedy tokens are
also held against the reference ``Engine`` on the same parameters.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.model import ModelConfig as JConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import convert
from repro_torch.models.model import ModelConfig
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Completion, Engine, Request

TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=128)


@pytest.fixture(scope="module")
def engine():
    return Engine(ModelConfig(**TINY, dtype=torch.float32), seed=0,
                  device="cpu")


def _reqs():
    # two buckets (different prompt lengths) -> processed sequentially
    return [Request(0, np.arange(4, dtype=np.int32), max_new=4),
            Request(1, np.arange(7, dtype=np.int32), max_new=4)]


def test_first_token_before_total(engine):
    for c in engine.generate(_reqs()):
        assert 0.0 < c.first_token_s <= c.latency_s


def test_queued_bucket_includes_wait(engine):
    c0, c1 = engine.generate(_reqs())
    assert (c0.rid, c1.rid) == (0, 1)
    # request 1 waits while request 0's bucket runs: its latency includes
    # that wait, and even its first token lands after request 0 finished
    assert c1.latency_s > c0.latency_s
    assert c1.first_token_s >= c0.latency_s


def test_same_chunk_shares_timeline(engine):
    reqs = [Request(0, np.arange(5, dtype=np.int32), max_new=3),
            Request(1, np.arange(5, dtype=np.int32), max_new=3)]
    c0, c1 = engine.generate(reqs)
    assert c0.latency_s == c1.latency_s
    assert c0.first_token_s == c1.first_token_s


def test_prefill_only_request(engine):
    (c,) = engine.generate([Request(0, np.arange(5, dtype=np.int32),
                                    max_new=0)])
    assert c.tokens.shape == (0,)
    assert 0.0 < c.first_token_s <= c.latency_s


def test_executor_requires_coded_mode():
    from repro_torch.dist import CodedExecutor, FakeClock

    cfg = ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab=64, dtype=torch.float32)
    with CodedExecutor(2, clock=FakeClock()) as ex:
        with pytest.raises(ValueError, match="coded"):
            Engine(cfg, executor=ex, device="cpu")


def test_completion_defaults_keep_compat():
    c = Completion(0, np.zeros(1, np.int32), 1.0)
    assert c.first_token_s == 0.0


def test_request_arrival_default_keeps_compat():
    r = Request(0, np.arange(4, dtype=np.int32))
    assert r.arrival_s == 0.0


def test_buckets_run_in_arrival_order(engine):
    # rid 0 (len-4 bucket) is listed first but arrived later; rid 1's
    # len-7 bucket must be served first
    late = Request(0, np.arange(4, dtype=np.int32), max_new=4,
                   arrival_s=50.0)
    early = Request(1, np.arange(7, dtype=np.int32), max_new=4,
                    arrival_s=1.0)
    by_rid = {c.rid: c for c in engine.generate([late, early])}
    c_late, c_early = by_rid[0], by_rid[1]
    assert c_early.latency_s < c_late.latency_s
    assert c_late.first_token_s >= c_early.latency_s


def test_bucket_order_ties_fall_back_to_input_order(engine):
    c0, c1 = engine.generate(_reqs())
    assert c1.latency_s > c0.latency_s


def test_mid_batch_arrival_not_billed_for_preexisting_wait(engine,
                                                            monkeypatch):
    # a request stamped as arriving AFTER generate() entry measures from
    # its arrival (max(arrival, t0)).  The engine reads perf_counter at
    # entry, at the first token and at the end: on a counter that ticks
    # 10 ms per read these are 100.00, 100.01 and 100.02 s, and an
    # arrival at 100.005 s lands inside the window whatever the load.
    ticks = itertools.count()
    monkeypatch.setattr(tengine.time, "perf_counter",
                        lambda: 100.0 + 0.01 * next(ticks))
    reqs = [Request(0, np.arange(5, dtype=np.int32), max_new=3),
            Request(1, np.arange(5, dtype=np.int32), max_new=3,
                    arrival_s=100.005)]
    c0, c1 = engine.generate(reqs)
    assert c0.latency_s == pytest.approx(0.02)
    assert c0.first_token_s == pytest.approx(0.01)
    assert c1.latency_s == pytest.approx(0.015)
    assert c1.first_token_s == pytest.approx(0.005)
    assert c1.latency_s < c0.latency_s
    assert 0.0 <= c1.first_token_s <= c1.latency_s


def test_generate_tokens_equal_the_reference():
    """The same parameters (carried across through numpy) and prompts give
    the reference engine's greedy tokens: tiny widths keep every top-2
    margin far above the f32 differences of the two packages."""
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, n, dtype=np.int32) for n in (4, 7, 7)]
    want = JEngine(jcfg, params=jp).generate(
        [JRequest(i, p, max_new=5) for i, p in enumerate(prompts)])
    got = Engine(ModelConfig(**TINY, dtype=torch.float32), params=tp,
                 device="cpu").generate(
        [Request(i, p, max_new=5) for i, p in enumerate(prompts)])
    assert [c.rid for c in got] == [c.rid for c in want]
    for a, b in zip(got, want):
        assert a.tokens.tolist() == np.asarray(b.tokens).tolist()
