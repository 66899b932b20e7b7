"""The port's decoder model (the smoke variants of all ten architectures)
vs the JAX reference, on the reference's own parameters carried across
through numpy.

Logits are compared at ``1e-4 * max|logit|`` in f32; every cache leaf at
1e-4 of its own largest magnitude.  The building blocks (norm, RoPE,
attention) are compared one by one, and the copied configurations field by
field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, to_j, to_t
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM

ARCHS = list(tconfigs.ARCHS)
B, T = 2, 21


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, v in _leaves(tree[k]):
                yield (k,) + path, v
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for path, x in _leaves(v):
                yield (i,) + path, x
    else:
        yield (), tree


def _rel_close(got, want, rel, what):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: err {err:.3g} > {rel} * {scale:.3g}"


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, reference params, port cfg, port params)."""
    arch = request.param
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    return arch, jc, jp, tc, tp


def _jit(fn, cfg, **kw):
    """A reference model function, jitted once per config: eager JAX would
    compile op by op, several times slower on the CPU."""
    return jax.jit(functools.partial(fn, cfg, **kw))


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n)).astype(np.int32)


def test_forward_matches_reference(pair):
    _, jc, jp, tc, tp = pair
    toks = _tokens(jc, T, 1)
    want = _jit(JM.forward, jc)(jp, jnp.asarray(toks))
    got = TM.forward(tc, tp, torch.as_tensor(toks))
    assert got.dtype == torch.float32
    _rel_close(got, want, 1e-4, "logits")


def test_prefill_and_three_decode_steps_match_reference(pair):
    _, jc, jp, tc, tp = pair
    toks = _tokens(jc, T, 2)
    jl, jcache = _jit(JM.prefill, jc, max_seq=T + 3)(jp, jnp.asarray(toks))
    tl, tcache = TM.prefill(tc, tp, torch.as_tensor(toks), max_seq=T + 3)
    _rel_close(tl, jl, 1e-4, "prefill logits")
    # the reference stacks a homogeneous model's cache; the port lists it
    jlayers = jcache["layers"]
    if isinstance(jlayers, dict):
        jlayers = [jax.tree.map(lambda a, i=i: a[i], jlayers)
                   for i in range(jc.n_layers)]
    jleaves = dict(_leaves(jlayers))
    tleaves = dict(_leaves(tcache["layers"]))
    assert set(jleaves) == set(tleaves)
    for path in jleaves:
        _rel_close(tleaves[path], jleaves[path], 1e-4, f"cache {path}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == T
    nxt = np.asarray(jnp.argmax(jl[..., : jc.vocab], -1)).astype(np.int32)
    j_decode = jax.jit(lambda p, c, t: JM.decode_step(jc, p, c, token=t))
    for step in range(3):
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = TM.decode_step(tc, tp, tcache, token=torch.as_tensor(nxt))
        _rel_close(tl, jl, 1e-4, f"decode {step} logits")
        nxt = np.asarray(jnp.argmax(jl[..., : jc.vocab], -1)).astype(np.int32)
    assert int(tcache["pos"]) == T + 3


def test_prefill_decode_consistency_within_the_port(pair):
    """The reference's test_smoke_prefill_decode_consistency, on the port:
    prefill + decode == full forward on the reduced variant."""
    _, _, _, cfg, params = pair
    if cfg.is_moe:  # as the reference's test: no capacity drops
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    toks = torch.as_tensor(_tokens(cfg, 16, 3))
    lgp, cache = TM.prefill(cfg, params, toks, max_seq=20)
    nxt = lgp.argmax(-1)
    lgd, _ = TM.decode_step(cfg, params, cache, token=nxt)
    full = TM.forward(cfg, params, torch.cat([toks, nxt], 1))
    v = cfg.vocab
    scale = float(full[:, -1, :v].abs().max()) + 1e-9
    err = float((lgd[:, 0, :v] - full[:, -1, :v]).abs().max()) / scale
    assert err < 2e-2, err


def test_per_lane_positions_decode_like_scalar(pair):
    """A (B,) position vector whose lanes agree decodes exactly like the
    scalar position."""
    _, _, _, cfg, params = pair
    toks = torch.as_tensor(_tokens(cfg, 9, 4))
    _, cache = TM.prefill(cfg, params, toks, max_seq=12)
    nxt = torch.as_tensor([[3], [5]])
    a, ca = TM.decode_step(cfg, params, cache, token=nxt)
    vec = {**cache, "pos": torch.full((B,), 9, dtype=torch.int32)}
    b, cb = TM.decode_step(cfg, params, vec, token=nxt)
    assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    assert cb["pos"].tolist() == [10, 10] and int(ca["pos"]) == 10


def test_cache_and_param_tree_shapes(pair):
    _, jc, jp, tc, tp = pair
    assert TM.param_count(tp) == JM.param_count(jp)
    jcache = JM.init_cache(jc, 3, 11)
    tcache = TM.init_cache(tc, 3, 11, device="cpu")
    jlayers = jcache["layers"]
    if isinstance(jlayers, dict):
        jlayers = [jax.tree.map(lambda a, i=i: a[i], jlayers)
                   for i in range(jc.n_layers)]
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in _leaves(jlayers)}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _leaves(tcache["layers"])}
    assert got == want


def test_coded_matmul_path_matches_reference():
    """coded (5, 3) MDS without an executor: the FFN GEMMs go through the
    functional coded pipeline in both packages, and logits stay within
    roundoff of the uncoded reference."""
    arch = "zamba2-1.2b"
    coded = dict(coded_n=5, coded_k=3, n_layers=1)
    jc = dataclasses.replace(jconfigs.smoke_config(arch), **coded)
    tc = dataclasses.replace(tconfigs.smoke_config(arch), **coded)
    jp = JM.init_params(jc, jax.random.PRNGKey(5))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    toks = _tokens(jc, 11, 6)
    want = _jit(JM.forward, jc)(jp, jnp.asarray(toks))
    got = TM.forward(tc, tp, torch.as_tensor(toks))
    _rel_close(got, want, 1e-4, "coded logits")


def test_not_ported_parts_raise():
    """Every part of the decoder is ported.  What the reference refuses,
    the port refuses with the reference's errors: chunked resume and
    packed prefill outside dense attention (SSM state, MoE capacity
    routing)."""
    toks = np.zeros((1, 4), np.int32)
    for arch in ("zamba2-1.2b", "dbrx-132b", "kimi-k2-1t-a32b"):
        jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
        tp = TM.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        for call in (
                lambda M, c, p, t: M.prefill_resume(c, p, {"pos": 0}, t),
                lambda M, c, p, t: M.prefill(c, p, t, lens=[4])):
            with pytest.raises(ValueError) as want:
                call(JM, jc, jp, jnp.asarray(toks))
            with pytest.raises(ValueError) as got:
                call(TM, tc, tp, torch.as_tensor(toks))
            assert str(got.value) == str(want.value)
        assert not TM.supports_prefill_pack(tc)
        assert not JM.supports_prefill_pack(jc)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    s = rng.normal(size=(16,)).astype(np.float32) * 0.1
    _rel_close(tcommon.rms_norm(to_t(x), to_t(s)),
               jcommon.rms_norm(to_j(x), to_j(s)), 1e-6, "rms_norm")


@pytest.mark.parametrize("pos_shape", ["T", "BT"])
def test_rope_matches_reference(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = (np.arange(7) if pos_shape == "T" else
           rng.integers(0, 50, (2, 7))).astype(np.int32)
    _rel_close(tcommon.rope(to_t(x), torch.as_tensor(pos), 1e4),
               jcommon.rope(to_j(x), jnp.asarray(pos), 1e4), 1e-6, "rope")


@pytest.mark.parametrize("vector", [False, True])
def test_rope_at_matches_reference(vector):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    pos = np.asarray([4, 17, 30], np.int32) if vector else np.int32(13)
    _rel_close(tcommon.rope_at(to_t(x), torch.as_tensor(pos)),
               jcommon.rope_at(to_j(x), jnp.asarray(pos)), 1e-6, "rope_at")


@pytest.mark.parametrize("T_,H,K,bq,bk,window", [
    (16, 4, 4, 512, 512, 0),
    (19, 4, 2, 8, 4, 0),      # GQA, ragged blocks
    (12, 2, 1, 4, 4, 5),      # MQA, sliding window
])
def test_blockwise_causal_attention_matches_reference(T_, H, K, bq, bk,
                                                      window):
    rng = np.random.default_rng(T_ + H)
    q = rng.normal(size=(2, T_, H, 8)).astype(np.float32)
    k = rng.normal(size=(2, T_, K, 8)).astype(np.float32)
    v = rng.normal(size=(2, T_, K, 8)).astype(np.float32)
    got = tattn.blockwise_causal_attention(to_t(q), to_t(k), to_t(v),
                                           window=window, block_q=bq,
                                           block_k=bk)
    want = jattn.blockwise_causal_attention(to_j(q), to_j(k), to_j(v),
                                            window=window, block_q=bq,
                                            block_k=bk)
    _rel_close(got, want, 1e-5, "attention")


@pytest.mark.parametrize("pos", [3, 11, 40, "lanes"])
def test_decode_attention_matches_reference(pos):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    kc = rng.normal(size=(3, 12, 2, 8)).astype(np.float32)
    vc = rng.normal(size=(3, 12, 2, 8)).astype(np.float32)
    p = np.asarray([2, 11, 30], np.int32) if pos == "lanes" else np.int32(pos)
    got = tattn.decode_attention(to_t(q), to_t(kc), to_t(vc),
                                 torch.as_tensor(p))
    want = jattn.decode_attention(to_j(q), to_j(kc), to_j(vc), jnp.asarray(p))
    _rel_close(got, want, 1e-5, "decode attention")


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (str(v).replace("torch.", "") if f.name == "dtype"
                       else v)
    if not isinstance(cfg.dtype, torch.dtype):
        out["dtype"] = jnp.dtype(cfg.dtype).name
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"] + list(
    jconfigs.INPUT_SHAPES))
def test_configs_equal_the_reference_field_by_field(arch, variant):
    if variant == "full":
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    elif variant == "smoke":
        j, t = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    else:
        j = jconfigs.for_shape(jconfigs.get_config(arch),
                               jconfigs.INPUT_SHAPES[variant])
        t = tconfigs.for_shape(tconfigs.get_config(arch),
                               tconfigs.INPUT_SHAPES[variant])
    assert _fields(t) == _fields(j)
    assert (t.hd, t.padded_vocab, t.is_moe) == (j.hd, j.padded_vocab,
                                                j.is_moe)
    assert dataclasses.asdict(t.ssm_dims) == dataclasses.asdict(j.ssm_dims)
    assert [t.has_shared_attn(i) for i in range(t.n_layers)] == \
        [j.has_shared_attn(i) for i in range(j.n_layers)]


def test_input_shapes_and_registry():
    assert {k: dataclasses.asdict(v) for k, v in
            tconfigs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert tconfigs.LONG_WINDOW == jconfigs.LONG_WINDOW
    assert tconfigs.ARCHS == jconfigs.ARCHS
    with pytest.raises(KeyError):
        tconfigs.get_config("llama-70b")


@pytest.mark.parametrize("arch,table", [
    ("zamba2-1.2b", (38, 2048, 32, 32, 8192, 32000)),
    ("mamba2-2.7b", (64, 2560, 1, 1, 0, 50280)),
    ("gemma-2b", (18, 2048, 8, 1, 16384, 256000)),
    ("minicpm-2b", (40, 2304, 36, 36, 5760, 122753)),
    ("qwen3-32b", (64, 5120, 64, 8, 25600, 151936)),
    ("deepseek-coder-33b", (62, 7168, 56, 8, 19200, 32256)),
    ("dbrx-132b", (40, 6144, 48, 8, 10752, 100352)),
    ("musicgen-medium", (48, 1536, 24, 24, 6144, 2048)),
    ("kimi-k2-1t-a32b", (61, 7168, 64, 8, 2048, 163840)),
    ("internvl2-1b", (24, 896, 14, 2, 4864, 151655)),
])
def test_full_config_matches_published_shapes(arch, table):
    """tests/test_arch_smoke.py's stale-config check, on the port's
    configs."""
    cfg = tconfigs.get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == table
    extra = {"zamba2-1.2b": lambda c: c.ssm_state == 64,
             "mamba2-2.7b": lambda c: c.ssm_state == 128,
             "gemma-2b": lambda c: c.head_dim == 256 and c.act == "geglu",
             "minicpm-2b": lambda c: c.act == "silu" and c.gated,
             "qwen3-32b": lambda c: c.qk_norm and c.head_dim == 128,
             "deepseek-coder-33b": lambda c: c.rope_theta == 1e5,
             "dbrx-132b": lambda c: c.n_experts == 16 and c.top_k == 4,
             "musicgen-medium": lambda c: (c.frontend == "audio"
                                           and not c.gated),
             "kimi-k2-1t-a32b": lambda c: c.n_experts == 384 and c.top_k == 8,
             "internvl2-1b": lambda c: (c.frontend == "vision"
                                        and c.rope_theta == 1e6)}
    assert extra[arch](cfg)
    assert TM.supports_prefill_pack(cfg) == (cfg.block == "attn"
                                             and not cfg.is_moe)


def test_convert_round_trip(pair):
    _, _, jp, _, tp = pair
    back = convert.model_params_to_numpy(tp)
    again = convert.model_params_from_numpy(back, device="cpu")
    for (p1, a), (p2, b) in zip(_leaves(tp), _leaves(again)):
        assert p1 == p2 and a.dtype == b.dtype and torch.equal(a, b)
    jl = jp["layers"]
    if isinstance(jl, dict):  # stacked reference: leaf i of layer l
        jl = [jax.tree.map(lambda a, i=i: a[i], jl) for i in
              range(len(tp["layers"]))]
    for (p1, a), (p2, b) in zip(_leaves(jl), _leaves(back["layers"])):
        assert p1 == p2 and np.array_equal(np.asarray(a, np.float32), b)


def test_convert_keeps_bf16_and_casts_on_request():
    jp = {"layers": [{"w": jnp.ones((2, 3), jnp.bfloat16),
                      "n": jnp.zeros((3,), jnp.float32)}],
          "embed": jnp.ones((4, 3), jnp.bfloat16)}
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    assert tp["layers"][0]["w"].dtype == torch.bfloat16
    assert tp["layers"][0]["n"].dtype == torch.float32
    t32 = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu", dtype=torch.float32)
    assert t32["embed"].dtype == torch.float32
    with pytest.raises(ValueError):
        convert.model_params_from_numpy({"layers": []}, device="cpu")
