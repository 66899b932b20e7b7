"""Granite-4.0-H on the port (``HybridMoEConfig``) against its plain
reference, ``perfbench/configs/granite-4.0-h-small.ref.py`` (torch alone,
f32, its own SSD chunk of 64 and its own per-expert loop), on seeded
random weights at a tiny size on the CPU: 10 layers with attention at 5,
d 128, 8 experts of which a share is held, top-2.

Tolerances: the program runs in f32 here, so it differs from the
reference only in the order of its sums (the SSD in chunks of 16 against
the reference's 64, the blockwise attention's online softmax, the experts
summed by slot instead of by expert): logits within 1e-4 of the largest
logit, ~40 layers' worth of f32 roundings (2^-24 each, a few hundred deep)
with room.  Where both sides compute the same products in the same order
(the grouped GEMM's fallback, the shares of one layer) the bound is 1e-5
relative.  A routing near tie (the k-th and k+1-th router scores within
1e-4) could route the two sides differently: every test asserts that none
occurs on its inputs, so no tolerance covers one."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist import MeshExecutor
from repro_torch.kernels.grouped_gemm import grouped_gemm, grouped_gemm_plain
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import moe
from repro_torch.serving import Engine, Request
from repro_torch.serving.scheduler import ServingScheduler

ROOT = Path(__file__).resolve().parents[1]
REF_PATH = ROOT / "perfbench" / "configs" / "granite-4.0-h-small.ref.py"
LOGIT_TOL = 1e-4
SAME_ORDER_TOL = 1e-5


def _load_ref():
    spec = importlib.util.spec_from_file_location("granite_ref", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_ref()


def _model(held=4, n_experts=8):
    return dict(name="granite-tiny", n_layers=10, d_model=128, n_heads=4,
                n_kv_heads=2, d_ff=32, vocab=300, block="hybrid",
                n_experts=n_experts, top_k=2, ssm_state=16, ssm_expand=2,
                ssm_head_dim=16, ssm_conv=4, ssm_chunk=16,
                layer_types=["attn" if i == 5 else "mamba"
                             for i in range(10)],
                experts_held=held, shared_d_ff=48,
                embed_scale=12.0, residual_scale=0.22, logits_scale=16.0,
                # 1/head_dim, as Granite's 1/128 at its head_dim 128
                attn_scale=1 / 32, positional="nope", norm_eps=1e-5,
                dtype="float32")


def _cfg(**kw):
    return {"model": _model(**kw), "rms_norm_eps": 1e-5, "embed_std": 0.05}


def _port(cfg):
    m = dict(cfg["model"], dtype=getattr(torch, cfg["model"]["dtype"]),
             layer_types=tuple(cfg["model"]["layer_types"]))
    return TM.HybridMoEConfig(**m)


def _params(cfg, seed=0):
    return REF.make_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _margin(cfg, params, tokens):
    """The smallest gap between the k-th and k+1-th router scores over
    every (token, layer) of the reference's forward."""
    m = cfg["model"]
    gaps = []
    orig = REF.routed

    def spy(p, u, m_, q, ties=None):
        s = u.reshape(-1, u.shape[-1]) @ p["router"].float()
        top = torch.topk(s, m_["top_k"] + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return orig(p, u, m_, q, ties)

    REF.routed = spy
    try:
        REF.forward(cfg, params, tokens)
    finally:
        REF.routed = orig
    assert len(gaps) == m["n_layers"]
    return min(gaps)


def _tokens(seed, B=2, T=40, V=300):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, V, (B, T)))


def test_registered_beside_archs():
    cfg = get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" not in ARCHS
    assert isinstance(cfg, TM.HybridMoEConfig)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attn"] == \
        [5, 15, 25, 35]
    assert (cfg.n_experts, cfg.experts_held, cfg.top_k, cfg.d_ff,
            cfg.shared_d_ff) == (72, 18, 10, 768, 1536)
    assert (cfg.embed_scale, cfg.residual_scale, cfg.logits_scale,
            cfg.attn_scale, cfg.positional, cfg.norm_eps) == (
        12.0, 0.22, 16.0, 0.0078125, "nope", 1e-5)


def test_base_config_keeps_the_references_fields():
    """The hybrid settings are fields of HybridMoEConfig only; every other
    configuration keeps the reference's values for them."""
    base = {f.name for f in dataclasses.fields(TM.ModelConfig)}
    hybrid = {f.name for f in dataclasses.fields(TM.HybridMoEConfig)}
    assert "layer_types" not in base and "layer_types" in hybrid
    z = get_config("zamba2-1.2b")
    assert (z.layer_types, z.experts_held, z.embed_scale, z.residual_scale,
            z.logits_scale, z.attn_scale, z.positional, z.norm_eps) == (
        (), 0, z.d_model ** 0.5, 1.0, 1.0, None, "rope", 1e-6)
    d = get_config("dbrx-132b")
    assert d.experts_held == d.n_experts > 0


def test_the_reference_layout_is_the_ports():
    cfg = _cfg()
    mine = _params(cfg)
    port = TM.init_params(_port(cfg), torch.Generator().manual_seed(0),
                          device="cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, (tuple(t.shape), t.dtype)

    assert dict(leaves(mine)) == dict(leaves(port))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_logits_match_the_reference(seed):
    cfg = _cfg()
    params = _params(cfg, seed)
    toks = _tokens(seed)
    assert _margin(cfg, params, toks) > 1e-4
    want = REF.forward(cfg, params, toks)
    got = TM.forward(_port(cfg), params, toks)[..., :300]
    assert _rel(got, want) < LOGIT_TOL


@pytest.mark.parametrize("split", [17, 32])
def test_prefill_then_decode_match_the_full_forward(split):
    cfg = _cfg()
    params = _params(cfg, 3)
    toks = _tokens(3)
    assert _margin(cfg, params, toks) > 1e-4
    want = REF.forward(cfg, params, toks)
    pc = _port(cfg)
    logits, cache = TM.prefill(pc, params, toks[:, :split], max_seq=40)
    assert _rel(logits[:, 0, :300], want[:, split - 1]) < LOGIT_TOL
    for t in range(split, 40):
        logits, cache = TM.decode_step(pc, params, cache,
                                       token=toks[:, t:t + 1])
        assert _rel(logits[:, 0, :300], want[:, t]) < LOGIT_TOL


def test_two_shares_add_up_to_the_whole_layer():
    """Experts 0-3 on one device and 4-7 on the other: their routed parts,
    plus the shared expert counted once, give the uncut reference's FFN
    output of the layer."""
    cfg = _cfg(held=8)
    whole = _params(cfg, 5)["layers"][0]
    u = torch.randn(2, 12, 128, generator=torch.Generator().manual_seed(5))
    m = cfg["model"]
    want = (REF.routed(whole["moe"], u, m, lambda w: w.float())
            + REF.ffn(whole["shared"], u, lambda w: w.float()))
    parts = []
    for first in (0, 4):
        share = dict(whole["moe"], **{k: whole["moe"][k][first:first + 4]
                                      for k in ("w_in", "w_gate", "w_out")})
        parts.append(moe.dropless_moe(share, u, 2, first))
    got = parts[0] + parts[1] + TM._ffn(_port(cfg), whole["shared"], u)
    assert _rel(got, want) < SAME_ORDER_TOL
    # and the first share is the reference's own share of 4 experts
    assert _rel(parts[0], REF.routed(
        dict(whole["moe"], **{k: whole["moe"][k][:4]
                              for k in ("w_in", "w_gate", "w_out")}),
        u, dict(m, experts_held=4), lambda w: w.float())) < SAME_ORDER_TOL


def test_no_slot_is_dropped_when_every_token_picks_one_expert():
    cfg = _cfg()
    p = dict(_params(cfg, 7)["layers"][0]["moe"])
    # inputs with a common positive part, and expert 2's router column
    # all ones: its score (~128) stands far above the others' (~1)
    u = torch.randn(3, 50, 128,
                    generator=torch.Generator().manual_seed(7)) + 1.0
    router = p["router"].clone()
    router[:, 2] = 1.0
    p["router"] = router
    counters = moe.MoECounters()
    with moe.counting(counters):
        got = moe.dropless_moe(p, u, 2, 0)
    flat = u.reshape(-1, 128)
    top = torch.topk(flat @ router, 2, -1).indices
    assert bool((top == 2).any(-1).all())  # every token routes to expert 2
    c = counters.read()
    assert c["dropped"] == 0 and c["max_group"] == 150
    assert c["rows"] == int((top < 4).sum()) and c["calls"] == 1
    want = REF.routed(p, u, cfg["model"], lambda w: w.float())
    assert _rel(got, want) < SAME_ORDER_TOL


def test_grouped_gemm_fallback_matches_per_expert_matmuls():
    g = torch.Generator().manual_seed(11)
    G, K, N, M = 6, 24, 20, 30
    x = torch.randn(M, K, generator=g)
    w = torch.randn(G, K, N, generator=g)
    sizes = [5, 0, 9, 0, 0, 12]          # empty groups among them
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32)
    R = 30                               # 4 rows past the last group
    rows = torch.randint(0, M, (R,), generator=g, dtype=torch.int32)
    scale = torch.rand(R, generator=g)
    dst = torch.randperm(R, generator=g).to(torch.int32)
    out = grouped_gemm(x, w, offsets, rows=rows, scale=scale, dst=dst,
                       out=torch.zeros(R, N))
    want = torch.zeros(R, N)
    off = offsets.tolist()
    for e in range(G):
        for r in range(off[e], off[e + 1]):
            want[dst[r]] = scale[r] * (x[rows[r]] @ w[e])
    assert _rel(out, want) < SAME_ORDER_TOL
    untouched = dst[off[-1]:].long()
    assert bool((out[untouched] == 0).all())
    plain = grouped_gemm_plain(x, w, offsets, rows=rows)
    for e in range(G):
        lo, hi = off[e], off[e + 1]
        assert torch.allclose(plain[lo:hi], x[rows[lo:hi].long()] @ w[e],
                              rtol=SAME_ORDER_TOL, atol=SAME_ORDER_TOL)


@pytest.mark.parametrize("sizes", [[5, 0, 9, 0, 0, 12], [0, 0, 200, 1],
                                   [64, 64, 65, 0], [1, 1, 1, 1, 1, 1]],
                         ids=["ragged", "one-big", "block-edges", "decode"])
def test_the_row_blocks_cover_every_held_row_once(sizes):
    """The kernel's grid (``gemm_plan``) and its blocks' walk over the
    offsets (``row_blocks``) cover each row below ``offsets[G]`` exactly
    once, and the plain version's ``done`` counts those rows."""
    from repro_torch.kernels import grouped_gemm as gg

    off = [0, *np.cumsum(sizes).tolist()]
    R = off[-1] + 7                      # slots of experts held elsewhere
    seen = []
    for g, lo, hi in gg.row_blocks(off, R):
        assert off[g] <= lo < hi <= off[g + 1]
        assert hi - lo <= gg.gemm_plan(R, len(sizes))[0]
        seen += range(lo, hi)
    assert sorted(seen) == list(range(off[-1]))
    x = torch.randn(R, 32, generator=torch.Generator().manual_seed(3))
    w = torch.randn(len(sizes), 32, 8)
    done = torch.zeros((), dtype=torch.int64)
    grouped_gemm(x, w, torch.tensor(off, dtype=torch.int32), done=done)
    assert int(done) == off[-1]


def test_a_short_grid_is_counted_as_dropped(monkeypatch):
    """A grid one row block short of the experts' rows leaves slots of a
    held expert uncomputed: the counters' ``dropped`` reads them."""
    from repro_torch.kernels import grouped_gemm as gg

    cfg = _cfg()
    p = _params(cfg, 7)["layers"][0]["moe"]
    u = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(5))
    sound = moe.MoECounters()
    with moe.counting(sound):
        moe.dropless_moe(p, u, 2, 0)
    assert sound.read()["dropped"] == 0
    plan = gg.gemm_plan
    monkeypatch.setattr(gg, "gemm_plan", lambda rows, groups: (
        plan(rows, groups)[0], 1))
    short = moe.MoECounters()
    with moe.counting(short):
        moe.dropless_moe(p, u, 2, 0)
    c = short.read()
    assert c["dropped"] > 0 and c["rows"] + c["dropped"] == \
        sound.read()["rows"]


def _direct(q, k, v, scale, q0=0):
    """softmax(q k^T scale) v, causal, the heads of a GQA group repeated:
    q (B, Tq, H, P) at positions q0.., k, v (B, S, K, P)."""
    H, K = q.shape[2], k.shape[2]
    k = k.repeat_interleave(H // K, 2)
    v = v.repeat_interleave(H // K, 2)
    s = torch.einsum("bthp,bshp->bhts", q, k) * scale
    Tq, S = q.shape[1], k.shape[1]
    mask = torch.arange(S)[None, :] <= (q0 + torch.arange(Tq))[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhts,bshp->bthp", torch.softmax(s, -1), v)


@pytest.mark.parametrize("scale", [None, 0.0078125])
def test_attention_scale_against_a_direct_softmax(scale):
    g = torch.Generator().manual_seed(13)
    q = torch.randn(2, 24, 4, 16, generator=g) * 4
    k = torch.randn(2, 24, 2, 16, generator=g) * 4
    v = torch.randn(2, 24, 2, 16, generator=g)
    s = 16 ** -0.5 if scale is None else scale
    want = _direct(q, k, v, s)
    got = tattn.blockwise_causal_attention(q, k, v, block_q=8, block_k=8,
                                           scale=scale)
    assert _rel(got, want) < SAME_ORDER_TOL
    got = tattn.flash_causal_attention(q, k, v, 0, 8, 8, scale)
    assert _rel(got, want) < SAME_ORDER_TOL
    got = tattn.decode_attention(q[:, -1:], k, v, 23, scale)
    assert _rel(got, want[:, -1:]) < SAME_ORDER_TOL
    got = tattn.chunk_attention(q[:, 16:], k, v, 16, scale)
    assert _rel(got, want[:, 16:]) < SAME_ORDER_TOL


def test_nope_attention_layer_reads_no_positions():
    """With NoPE the attention mixer is the direct softmax of the
    projections themselves, at the configured scale."""
    cfg = _cfg()
    pc = _port(cfg)
    p = _params(cfg, 17)["layers"][5]["attn"]
    x = torch.randn(1, 20, 128, generator=torch.Generator().manual_seed(17))
    out, kv = TM._prefill_attn_mixer(pc, p, x, torch.arange(20), 0, 20)
    q = torch.einsum("btd,dhp->bthp", x, p["wq"])
    k = torch.einsum("btd,dkp->btkp", x, p["wk"])
    v = torch.einsum("btd,dkp->btkp", x, p["wv"])
    want = torch.einsum("bthp,hpd->btd", _direct(q, k, v, pc.attn_scale),
                        p["wo"])
    assert _rel(out, want) < SAME_ORDER_TOL
    assert torch.equal(kv["k"], k)  # cached as projected: no rotation


def test_served_by_the_scheduler_on_the_mesh_with_counters():
    """Engine + ServingScheduler on MeshExecutor, (10, 6) MDS with a dead
    and a straggling lane: every request served, the tokens the uncoded
    engine's, the routed slots all computed or held elsewhere."""
    cfg = _cfg()
    params = _params(cfg, 19)
    pc = _port(cfg)
    reqs = [Request(i, np.random.default_rng(i).integers(0, 300, 16 + 8 * i),
                    4, 0.01 * i) for i in range(4)]
    plain = Engine(pc, params=params, device="cpu").generate(reqs)
    eng = Engine(pc, params=params, coded=(10, 6), scheme="mds",
                 executor=MeshExecutor(dead=(1,), stragglers=(2,)),
                 max_batch=4, device="cpu")
    res = ServingScheduler(eng, max_seq=64, max_batch=4).serve(reqs)
    got = {c.rid: list(c.tokens) for c in res.completions}
    assert got == {c.rid: list(c.tokens) for c in plain}
    c = eng.moe_counters.read()
    assert c["calls"] > 0 and c["dropped"] == 0 and c["rows"] > 0
    assert eng.executor.run_count > 0


def test_spans_of_a_hybrid_layer_nest():
    """Under a profiler a hybrid prefill records each mixer as
    ``repro.model.mamba`` or ``repro.model.attn`` and each FFN as
    ``repro.model.moe``, which holds ``repro.moe.route``, ``.experts`` and
    ``.combine``."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    params = _params(cfg, 23)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TM.prefill(_port(cfg), params, _tokens(23, B=1, T=8), max_seq=8)
    ev = [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith("repro.")]
    names = [n for n, *_ in ev]
    assert names.count("repro.model.mamba") == 9
    assert names.count("repro.model.attn") == 1
    assert names.count("repro.model.moe") == 10
    moe_spans = [(s, e) for n, s, e in ev if n == "repro.model.moe"]
    for part in ("repro.moe.route", "repro.moe.experts", "repro.moe.combine"):
        inner = [(s, e) for n, s, e in ev if n == part]
        assert len(inner) == 10
        assert all(any(ms <= s and e <= me for ms, me in moe_spans)
                   for s, e in inner)
