"""The port's flash attention, forward and backward, vs the JAX reference.

``attention.py::_flash_fwd_impl`` returns ``out`` (B, T, H, P) and the
log-sum-exp ``lse`` (B, K, G, T); ``flash_causal_attention`` its ``out``.
Both are held against the reference's on the same numpy inputs, with T no
multiple of the blocks, block_q != block_k, a sliding window and GQA/MQA,
and against the port's ``blockwise_causal_attention`` (the same online
softmax).  Tolerances: ``out`` within 1e-5 of its largest magnitude, and
``lse`` within 1e-5 of its largest magnitude (f32 online softmax at other
summation orders; head_dim 8 and 16); bf16 ``out`` within 2 bf16 unit
roundoffs 2^-8 (the output cast on both sides).  The blockwise and the
flash forward run the same arithmetic: they agree bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import U16, as_np, to_j, to_t
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.optim import tree_leaves

CASES = [
    # B, T, H, K, P, block_q, block_k, window
    (2, 16, 4, 4, 8, 512, 512, 0),     # one block, MHA
    (2, 19, 4, 2, 8, 8, 4, 0),         # GQA, T no multiple, bq != bk
    (1, 23, 6, 3, 16, 4, 8, 0),        # bq < bk, ragged
    (2, 12, 2, 1, 8, 4, 4, 5),         # MQA, sliding window
    (2, 29, 4, 2, 8, 8, 6, 7),         # GQA, window, lcm(8, 6) = 24 pad
]


def _qkv(B, T, H, K, P, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.normal(size=(B, T, K, P)).astype(np.float32),
            rng.normal(size=(B, T, K, P)).astype(np.float32))


def _rel_close(got, want, rel, what):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: err {err:.3g} > {rel} * {scale:.3g}"


@pytest.mark.parametrize("B,T,H,K,P,bq,bk,window", CASES)
def test_flash_fwd_impl_out_and_lse_match_reference(B, T, H, K, P, bq, bk,
                                                    window):
    q, k, v = _qkv(B, T, H, K, P, T + H)
    ref = jax.jit(functools.partial(jattn._flash_fwd_impl, window=window,
                                    block_q=bq, block_k=bk))
    j_out, j_lse = ref(to_j(q), to_j(k), to_j(v))
    t_out, t_lse = tattn._flash_fwd_impl(to_t(q), to_t(k), to_t(v), window,
                                         bq, bk)
    assert tuple(t_lse.shape) == (B, K, H // K, T)
    assert t_lse.dtype == torch.float32
    _rel_close(t_out, j_out, 1e-5, "out")
    _rel_close(t_lse, j_lse, 1e-5, "lse")
    # lse is the log of each query's softmax normaliser: exact in f64
    s = np.einsum("bqkgp,bskp->bkgqs",
                  q.reshape(B, T, K, H // K, P).astype(np.float64),
                  k.astype(np.float64)) * P ** -0.5
    i, j = np.arange(T)[:, None], np.arange(T)[None, :]
    mask = (j <= i) & ((i - j < window) if window else True)
    s = np.where(mask, s, -np.inf)
    m = s.max(-1)
    lse64 = m + np.log(np.exp(s - m[..., None]).sum(-1))
    _rel_close(t_lse, lse64, 1e-5, "lse vs f64")


@pytest.mark.parametrize("B,T,H,K,P,bq,bk,window", CASES)
def test_flash_causal_attention_matches_reference_and_blockwise(
        B, T, H, K, P, bq, bk, window):
    q, k, v = _qkv(B, T, H, K, P, 2 * T + K)
    want = jattn.flash_causal_attention(to_j(q), to_j(k), to_j(v), window,
                                        bq, bk)
    got = tattn.flash_causal_attention(to_t(q), to_t(k), to_t(v), window,
                                       bq, bk)
    _rel_close(got, want, 1e-5, "flash")
    blockwise = tattn.blockwise_causal_attention(
        to_t(q), to_t(k), to_t(v), window=window, block_q=bq, block_k=bk)
    assert torch.equal(got, blockwise)


def test_flash_bf16_matches_reference():
    B, T, H, K, P = 2, 21, 4, 2, 16
    q, k, v = _qkv(B, T, H, K, P, 5)
    want = jattn.flash_causal_attention(to_j(q, "bfloat16"),
                                        to_j(k, "bfloat16"),
                                        to_j(v, "bfloat16"), 0, 8, 4)
    got = tattn.flash_causal_attention(to_t(q, "bfloat16"),
                                       to_t(k, "bfloat16"),
                                       to_t(v, "bfloat16"), 0, 8, 4)
    assert got.dtype == torch.bfloat16
    _rel_close(got, want, 2 * U16, "flash bf16")


@pytest.mark.parametrize("arch", ["gemma-2b", "dbrx-132b", "internvl2-1b"])
def test_model_forward_with_flash_vjp_matches_reference(arch):
    """``flash_vjp=True`` routes the model's attention through
    ``flash_causal_attention`` in both packages: logits within 1e-4 of
    their largest magnitude (the model tests' tolerance), and the port's
    equal to its own blockwise forward."""
    small = dict(flash_vjp=True, block_q=8, block_k=4)
    jc = dataclasses.replace(jconfigs.smoke_config(arch), **small)
    tc = dataclasses.replace(tconfigs.smoke_config(arch), **small)
    jp = JM.init_params(jc, jax.random.PRNGKey(2))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 19)).astype(
        np.int32)
    want = jax.jit(functools.partial(JM.forward, jc))(jp, jnp.asarray(toks))
    got = TM.forward(tc, tp, torch.as_tensor(toks))
    _rel_close(got, want, 1e-4, "flash logits")
    plain = TM.forward(dataclasses.replace(tc, flash_vjp=False), tp,
                       torch.as_tensor(toks))
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------------
# the backward: the reference's custom VJP, ported
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_flash_grad(window, bq, bk):
    def obj(q, k, v, do):
        return jnp.sum(jattn.flash_causal_attention(q, k, v, window, bq, bk)
                       * do)
    return jax.jit(jax.grad(obj, argnums=(0, 1, 2)))


@pytest.mark.parametrize("B,T,H,K,P,bq,bk,window", CASES)
def test_flash_backward_matches_jax_grad_of_the_reference(B, T, H, K, P, bq,
                                                          bk, window):
    """dq, dk, dv of ``flash_causal_attention`` (``_flash_bwd``: the
    probabilities recomputed from the saved log-sum-exp) against
    ``jax.grad`` through the reference's custom VJP, within 1e-5 of each
    gradient's largest magnitude (f32 sums of at most T x P products in
    other orders), and against autograd through the port's blockwise
    forward within the same."""
    q, k, v = _qkv(B, T, H, K, P, 3 * T + H)
    do = np.random.default_rng(T).normal(size=(B, T, H, P)).astype(
        np.float32)
    want = _jax_flash_grad(window, bq, bk)(to_j(q), to_j(k), to_j(v),
                                           to_j(do))

    def grads(fn):
        ins = [to_t(a).requires_grad_(True) for a in (q, k, v)]
        return torch.autograd.grad(fn(*ins), ins, to_t(do))

    got = grads(lambda a, b, c: tattn.flash_causal_attention(
        a, b, c, window, bq, bk))
    plain = grads(lambda a, b, c: tattn.blockwise_causal_attention(
        a, b, c, window=window, block_q=bq, block_k=bk))
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == torch.float32
        _rel_close(g, w, 1e-5, f"{name} vs reference")
        _rel_close(g, p, 1e-5, f"{name} vs blockwise autograd")


def test_flash_backward_keeps_no_probabilities_and_types():
    """The saved residuals are (q, k, v, out, lse): nothing of size T^2;
    bf16 inputs get bf16 gradients."""
    B, T, H, K, P = 1, 40, 2, 1, 8
    q, k, v = (to_t(a, "bfloat16").requires_grad_(True)
               for a in _qkv(B, T, H, K, P, 9))
    out = tattn.flash_causal_attention(q, k, v, 0, 8, 8)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and max(t.numel() for t in saved) == B * T * H * P
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_model_gradient_with_flash_vjp_equals_blockwise_autograd():
    """A smoke gemma-2b loss differentiated with ``flash_vjp=True`` (the
    custom backward) and without (autograd through the blockwise
    forward): every parameter's gradient within 1e-4 of its largest
    magnitude."""
    cfg = dataclasses.replace(tconfigs.smoke_config("gemma-2b"), block_q=8,
                              block_k=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 19)))

    def grads(flash):
        c = dataclasses.replace(cfg, flash_vjp=flash)
        return torch.autograd.grad(TM.forward(c, params, toks).logsumexp(
            -1).mean(), leaves)

    for g, w in zip(grads(True), grads(False)):
        _rel_close(g, w, 1e-4, "model gradient")
