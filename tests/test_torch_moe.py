"""The port's routed mixture of experts vs the JAX reference.

``models/model.py::_moe_ffn`` on numpy-seeded inputs and the reference's
own expert weights carried across through numpy: with capacity_factor 4.0
no slot is dropped; at 1.25 a router biased towards two experts overflows
them, and the port drops exactly the reference's (token, slot) pairs.
Routing is top-k of a softmax: where ``torch.topk`` and ``lax.top_k`` pick
differently, the two gate probabilities at the boundary must lie within
1e-6 (a near-tie, not a fault) and the token is left out of the output
comparison.  Tolerances: f32 outputs within 1e-5 of the largest output
(two summation orders of contractions at most 128 deep, ~2 (D+F) 2^-24
each); bf16 within 8 bf16 unit roundoffs 2^-8 of the largest output (the
buffer, h, act(g)*h and each expert output are rounded to bf16 in both
packages, at other summation orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import U16, as_np, to_j, to_t
from repro import configs as jconfigs
from repro.dist import CodedExecutor as JCodedExecutor
from repro.dist import DeterministicDelay as JDelay
from repro.dist import FakeClock as JFakeClock
from repro.dist import FaultPlan as JFaultPlan
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.models import model as TM
from repro_torch.serving import Engine, Request

D, FF = 32, 48
NEAR_TIE = 1e-6


def _cfgs(E, K, cf, dtype="float32"):
    base = dict(name="moe", n_layers=1, d_model=D, n_heads=2, n_kv_heads=2,
                d_ff=FF, vocab=64, n_experts=E, top_k=K, capacity_factor=cf)
    jc = JM.ModelConfig(**base, dtype=getattr(jnp, dtype))
    tc = TM.ModelConfig(**base, dtype=getattr(torch, dtype))
    return jc, tc


def _moe_params(jc, seed, bias=0.0):
    """The reference's ``_init_moe`` weights, the router's columns 0 and 1
    shifted by ``bias`` (scaled by each token's mean input)."""
    p = jax.tree.map(np.asarray, JM._init_moe(jax.random.PRNGKey(seed), jc))
    if bias:
        p["router"] = p["router"].copy()
        p["router"][:, :2] += bias
    return p


def _inputs(B, T, seed, bias=0.0):
    x = np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)
    if bias:  # a positive mean, so that the biased columns win
        x += 0.5
    return x


def _reference_routing(jc, router, flat):
    probs = jax.nn.softmax(jnp.asarray(flat, jnp.float32)
                           @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, jc.top_k)
    return np.asarray(probs, np.float64), np.asarray(idx)


def _plain_keep(idx, E, C):
    """Capacity, slot by slot in flattened (token, slot) order: an
    independent statement of the reference's exclusive-cumsum rule."""
    seen = np.zeros(E, np.int64)
    keep = []
    for e in idx.reshape(-1):
        keep.append(seen[e] < C)
        seen[e] += 1
    return np.asarray(keep)


def _routing_agreement(tc, probs, jidx, tidx):
    """Tokens whose top-k sets agree; every disagreement must be a
    near-tie at the k-th probability."""
    same = np.array([set(a) == set(b) for a, b in zip(jidx, tidx)])
    srt = -np.sort(-probs, axis=-1)
    K = tc.top_k
    for t in np.nonzero(~same)[0]:
        gap = srt[t, K - 1] - srt[t, K]
        assert gap <= NEAR_TIE, (
            f"token {t}: routing {jidx[t]} vs {tidx[t]} with a top-k "
            f"boundary gap {gap:.3g} > {NEAR_TIE} (not a near-tie)")
    return same


def _check(E, K, cf, dtype="float32", bias=0.0, seed=0, B=3, T=11):
    jc, tc = _cfgs(E, K, cf, dtype)
    p = _moe_params(jc, seed, bias)
    tp = convert.model_params_from_numpy(
        {"layers": [p], "embed": np.zeros((1, 1), np.float32)},
        device="cpu")["layers"][0]
    x = _inputs(B, T, seed + 1, bias)
    want = jax.jit(lambda pp, xx: JM._moe_ffn(jc, pp, xx))(
        jax.tree.map(jnp.asarray, p), to_j(x, dtype))
    got = TM._moe_ffn(tc, tp, to_t(x, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape

    flat = as_np(to_t(x, dtype)).reshape(-1, D)
    probs, jidx = _reference_routing(jc, p["router"], flat)
    gates, eid, pos, keep, C = TM.moe_route(tc, tp["router"],
                                            to_t(x, dtype).reshape(-1, D))
    assert C == int(np.ceil(B * T * K / E * cf))
    tidx = eid.reshape(-1, K).numpy()
    same = _routing_agreement(tc, probs, jidx, tidx)
    want_keep = _plain_keep(jidx, E, C)
    if same.all():
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
    rows = same & (keep.numpy().reshape(-1, K)
                   == want_keep.reshape(-1, K)).all(-1)
    rel = 1e-5 if dtype == "float32" else 8 * U16
    g, w = as_np(got).reshape(-1, D)[rows], as_np(want).reshape(-1, D)[rows]
    err = float(np.abs(g - w).max())
    scale = float(np.abs(w).max())
    assert err <= rel * scale, f"err {err:.3g} > {rel} * {scale:.3g}"
    return int((~want_keep).sum()), int((~keep).sum()), int(rows.sum())


@pytest.mark.parametrize("E", [4, 16])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_moe_ffn_matches_reference_without_drops(E, K):
    want_drops, got_drops, rows = _check(E, K, 4.0, seed=E + K)
    assert want_drops == got_drops == 0
    assert rows == 33


@pytest.mark.parametrize("E", [4, 16])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_moe_ffn_drops_the_references_slots(E, K):
    """A router biased towards experts 0 and 1 overflows their capacity
    at 1.25: the port drops the reference's (token, slot) pairs.  With
    K = E every expert takes every token, Tt slots < C: nothing drops."""
    want_drops, got_drops, rows = _check(E, K, 1.25, bias=2.0,
                                         seed=10 + E + K)
    assert (want_drops > 0) == (K < E)
    assert got_drops == want_drops
    assert rows == 33


def test_moe_ffn_bf16_matches_reference():
    _check(16, 4, 1.25, dtype="bfloat16", bias=1.0, seed=3)


def test_moe_ffn_at_decode_size_drops_per_the_reference():
    """Four tokens, 16 experts, top 4: C = ceil(16/16 * 1.25) = 2, so
    an expert chosen by three of the tokens drops its third slot, as in
    the reference (kimi-k2's decode steps run at C = 1)."""
    want_drops, got_drops, _ = _check(16, 4, 1.25, bias=2.0, seed=5, B=4,
                                      T=1)
    assert got_drops == want_drops > 0


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_shapes_and_dtypes(arch, dtype):
    """The router is f32 whatever the model's type; the experts take the
    config's type; the tree equals the reference's in shape and type."""
    tc = dataclasses.replace(tconfigs.smoke_config(arch),
                             dtype=getattr(torch, dtype))
    jc = dataclasses.replace(jconfigs.smoke_config(arch),
                             dtype=getattr(jnp, dtype))
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    E, Dm, Fd = tc.n_experts, tc.d_model, tc.d_ff
    for layer in tp["layers"]:
        moe = layer["moe"]
        assert "ffn" not in layer
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["router"].shape) == (Dm, E)
        for name, shape in (("w_in", (E, Dm, Fd)), ("w_gate", (E, Dm, Fd)),
                            ("w_out", (E, Fd, Dm))):
            assert tuple(moe[name].shape) == shape
            assert moe[name].dtype == getattr(torch, dtype)
            # lecun: N(0, 1/fan_in), one expert at a time
            fan_in = shape[1]
            assert abs(float(moe[name].float().std()) * fan_in ** 0.5
                       - 1) < 0.1
    jmoe = jp["layers"]["moe"]  # stacked: a leading layer axis
    for name, leaf in jmoe.items():
        assert tuple(leaf.shape[1:]) == tuple(tp["layers"][0]["moe"][name]
                                              .shape)
        assert str(leaf.dtype) == str(tp["layers"][0]["moe"][name]
                                      .dtype).replace("torch.", "")
    assert TM.param_count(tp) == JM.param_count(jp)


def test_convert_keeps_the_router_f32_under_a_cast():
    jc = dataclasses.replace(jconfigs.smoke_config("dbrx-132b"),
                             dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(1)))
    tp = convert.model_params_from_numpy(jp, device="cpu",
                                         dtype=torch.bfloat16)
    for i, layer in enumerate(tp["layers"]):
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_in"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            layer["moe"]["router"].numpy(), jp["layers"]["moe"]["router"][i])
        np.testing.assert_array_equal(
            layer["moe"]["w_out"].float().numpy(),
            np.asarray(jp["layers"]["moe"]["w_out"][i], np.float32))
    back = convert.model_params_to_numpy(tp)
    assert back["layers"][1]["moe"]["w_gate"].shape == (4, 256, 512)


def test_coded_moe_config_dispatches_no_coded_run():
    """The reference codes only the dense FFN's GEMMs: an MoE config under
    coded (5, 3) with a live pool runs no coded op in either package, and
    both serve the uncoded tokens."""
    arch = "dbrx-132b"
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tc.vocab, 9, dtype=np.int32)
               for _ in range(3)]
    jex = JCodedExecutor(5, clock=JFakeClock(), delay_model=JDelay(1.0),
                         fault_plan=JFaultPlan(straggler={2: 9.0}))
    tex = tdist.CodedExecutor(
        5, clock=tdist.FakeClock(), delay_model=tdist.DeterministicDelay(1.0),
        fault_plan=tdist.FaultPlan(straggler={2: 9.0}))
    try:
        jgot = JEngine(jc, params=jp, coded=(5, 3), executor=jex).generate(
            [JRequest(i, p, max_new=4) for i, p in enumerate(prompts)])
        tgot = Engine(tc, params=tp, coded=(5, 3), executor=tex,
                      device="cpu").generate(
            [Request(i, p, max_new=4) for i, p in enumerate(prompts)])
        plain = Engine(tc, params=tp, device="cpu").generate(
            [Request(i, p, max_new=4) for i, p in enumerate(prompts)])
        assert jex.run_count == tex.run_count == 0
        assert jex.pool.dispatch_count == tex.pool.dispatch_count == 0
    finally:
        jex.close()
        tex.close()
    for a, b, c in zip(tgot, jgot, plain):
        assert a.tokens.tolist() == b.tokens.tolist() == c.tokens.tolist()
