"""The port's serving engine on the Zamba2 smoke variant.

Mirrors tests/test_dist_executor.py::test_engine_live_executor_matches_
jitted_serving: an ``Engine`` whose coded FFN GEMMs run live on a
``CodedExecutor`` pool (FakeClock, one 9x straggler) generates exactly the
tokens of the uncoded engine, decodes at the k-th arrival and never uses
the straggler's piece.  The port's tokens are also held against the JAX
reference ``Engine`` on the same parameters, wherever the reference's
top-2 logit margin is larger than the f32 tolerance.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.launch import serve
from repro_torch.serving import (Engine, Request, cache_cat, cache_take)

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def setup():
    jc, tc = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, 8, dtype=np.int32) for _ in range(3)]
    plain = Engine(tc, params=tp, device="cpu")
    reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
    return jc, jp, tc, tp, prompts, reqs, plain.generate(reqs)


def _executor(n, straggler=2, factor=9.0):
    return tdist.CodedExecutor(
        n, clock=tdist.FakeClock(), delay_model=tdist.DeterministicDelay(1.0),
        fault_plan=tdist.FaultPlan(straggler={straggler: factor}))


def test_live_executor_matches_uncoded_serving(setup):
    _, _, tc, tp, _, reqs, want = setup
    ex = _executor(5)
    try:
        live = Engine(tc, params=tp, coded=(5, 3), executor=ex, device="cpu")
        got = live.generate(reqs)
        r = ex.last_report
        assert r is not None, "the executor was bypassed"
        assert 2 not in r.subset      # the straggler's piece is never used
        assert r.t_complete == 1.0    # decode at the k-th arrival
        # 2 layers, each followed by the shared block: 2 FFNs x 3 GEMMs per
        # step, prefill + 3 decode steps of 3 lanes (3 >= k: all coded)
        assert ex.run_count == 2 * 3 * 4
        assert ex.pool.dispatch_count == 5 * ex.run_count
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert 0.0 < b.first_token_s <= b.latency_s
    finally:
        ex.close()


def test_tokens_match_the_reference_engine(setup):
    """Greedy tokens of the port equal the JAX reference's, except where
    the reference's own top-2 margin is within the f32 tolerance (a
    near-tie: either token is right, and the lanes then diverge)."""
    jc, jp, _, _, prompts, _, want = setup
    jeng = JEngine(jc, params=jp)
    jout = jeng.generate([JRequest(i, p, max_new=4)
                          for i, p in enumerate(prompts)])
    prefill = jax.jit(lambda p, t: JM.prefill(jc, p, t, max_seq=12))
    decode = jax.jit(lambda p, c, t: JM.decode_step(jc, p, c, token=t))
    toks = jnp.asarray(np.stack(prompts))
    logits, cache = prefill(jp, toks)
    steps = [np.asarray(logits[:, 0, : jc.vocab])]
    ref_tokens = np.stack([c.tokens for c in jout])      # (B, max_new)
    for s in range(3):
        logits, cache = decode(jp, cache, jnp.asarray(ref_tokens[:, s:s + 1]))
        steps.append(np.asarray(logits[:, 0, : jc.vocab]))
    checked = 0
    for lane, (a, b) in enumerate(zip(want, jout)):
        for s in range(4):
            if a.tokens[s] != b.tokens[s]:
                top2 = np.sort(steps[s][lane])[-2:]
                tol = 1e-4 * float(np.abs(steps[s][lane]).max())
                assert top2[1] - top2[0] <= tol, (lane, s, top2)
                break  # the lanes' histories differ from here on
            checked += 1
    assert checked >= 6


def test_retarget_coded(setup):
    _, _, tc, tp, _, reqs, want = setup
    ex = _executor(6, straggler=0, factor=30.0)
    try:
        eng = Engine(tc, params=tp, coded=(5, 3), executor=ex, device="cpu")
        eng.retarget_coded(6, 4)
        assert (eng.cfg.coded_n, eng.cfg.coded_k) == (6, 4)
        got = eng.generate(reqs[:1] + reqs[1:])
        r = ex.last_report
        assert len(r.assignment) == 6 and len(r.subset) == 4
        assert 0 not in r.subset and r.t_complete == 1.0
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    finally:
        ex.close()
    with pytest.raises(ValueError, match="coded engine"):
        Engine(tc, params=tp, device="cpu").retarget_coded(4)


def test_step_api_and_lane_membership(setup):
    """prefill_batch / decode_batch with cache_cat (join) and cache_take
    (leave) give each lane the tokens of one closed generate()."""
    _, _, tc, tp, prompts, _, want = setup
    eng = Engine(tc, params=tp, device="cpu")
    t0, c0 = eng.prefill_batch(np.stack(prompts[:2]), 12)
    t1, c1 = eng.prefill_batch(np.stack(prompts[2:]), 12)
    assert c0["pos"].tolist() == [8, 8]
    cache = cache_cat([c0, c1])
    toks = [np.concatenate([t0, t1])]
    for _ in range(3):
        nxt, cache = eng.decode_batch(cache, toks[-1])
        toks.append(nxt)
    got = np.stack(toks, axis=1)
    for lane in range(3):
        np.testing.assert_array_equal(got[lane], want[lane].tokens)
    kept = cache_take(cache, [2, 0])
    assert kept["pos"].tolist() == [11, 11]
    assert torch.equal(kept["layers"][0]["mamba"]["ssm"][0],
                       cache["layers"][0]["mamba"]["ssm"][2])
    one = cache_cat([c1])
    assert one["pos"].dim() == 1
    with pytest.raises(ValueError):
        cache_cat([])


def test_not_ported_options_raise(setup):
    _, _, tc, tp, _, _, _ = setup
    # the one-program backend is ported: the shorthand builds it
    eng = Engine(tc, params=tp, coded=(5, 3), executor="mesh", device="cpu")
    assert isinstance(eng.executor, tdist.MeshExecutor)
    # adaptive serving is ported: it needs a worker pool to learn from
    with pytest.raises(ValueError, match="adaptive=True needs an executor"):
        Engine(tc, params=tp, coded=(5, 3), adaptive=True, device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        Engine(tc, params=tp, coded=(5, 3), executor="threads", device="cpu")
    ex = _executor(5)
    try:
        with pytest.raises(ValueError, match="requires coded"):
            Engine(tc, params=tp, executor=ex, device="cpu")
    finally:
        ex.close()
    with pytest.raises(ValueError, match="selection scheme"):
        Engine(tc, params=tp, coded=(5, 3), segment=True, device="cpu")
    with pytest.raises(ValueError, match="unknown coding scheme"):
        Engine(tc, params=tp, coded=(5, 3), scheme="nope", device="cpu")


def test_engine_builds_its_own_params_from_a_seed():
    tc = tconfigs.smoke_config(ARCH)
    a = Engine(tc, seed=3, device="cpu")
    b = Engine(tc, seed=3, device="cpu")
    assert torch.equal(a.params["embed"], b.params["embed"])
    assert a.device == torch.device("cpu")


def _serve_cli(*extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--device", "cpu", "--smoke", "--requests", "2",
                         "--prompt-len", "8", "--max-new", "3",
                         "--coded", "5", "3", *extra])
    assert rc == 0
    return out.getvalue()


def test_serve_cli_runs_in_process():
    """The default --arch is the reference's, gemma-2b."""
    text = _serve_cli()
    assert "gemma-2b: served 2 requests, 6 tokens" in text
    assert "coded (n=5, k=3)" in text


def test_serve_cli_serves_zamba2_by_name():
    text = _serve_cli("--arch", "zamba2-1.2b")
    assert "zamba2-1.2b: served 2 requests, 6 tokens" in text
    assert "coded (n=5, k=3)" in text
