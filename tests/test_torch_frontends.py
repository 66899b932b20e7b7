"""The audio and vision architectures on the port vs the JAX reference.

musicgen-medium and internvl2-1b take precomputed frame/patch embeddings
(``models/frontends.py``).  A ``torch.Generator`` draws other numbers than
``jax.random``, so the reference's synthetic embeddings are handed across
as numpy: both packages prefill from them on the reference's parameters,
then decode three greedy steps by token and one by embedding.  Logits are
compared at 1e-4 of their largest magnitude in f32 (the model tests'
tolerance), every cache leaf at 1e-4 of its own largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro import configs as jconfigs
from repro.models import frontends as jfront
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import frontends as tfront
from repro_torch.models import model as TM

B, T = 2, 13
FRONTENDS = {"musicgen-medium": (jfront.synthetic_frames,
                                 tfront.synthetic_frames),
             "internvl2-1b": (jfront.synthetic_patches,
                              tfront.synthetic_patches)}


def _rel_close(got, want, rel, what):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: err {err:.3g} > {rel} * {scale:.3g}"


def _layers(cache, n):
    layers = cache["layers"]
    if isinstance(layers, dict):  # the reference stacks a homogeneous model
        layers = [jax.tree.map(lambda a, i=i: a[i], layers) for i in range(n)]
    return layers


@pytest.fixture(scope="module", params=sorted(FRONTENDS))
def pair(request):
    arch = request.param
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    jmake = FRONTENDS[arch][0]
    emb = np.array(jmake(jax.random.PRNGKey(1), B, T, jc.d_model,
                          dtype=jc.dtype), np.float32)
    return arch, jc, jp, tc, tp, emb


def test_configs_take_embeddings(pair):
    arch, jc, _, tc, _, _ = pair
    assert tc.frontend == jc.frontend == {"musicgen-medium": "audio",
                                          "internvl2-1b": "vision"}[arch]


def test_forward_from_embeddings_matches_reference(pair):
    _, jc, jp, tc, tp, emb = pair
    want = jax.jit(lambda p, e: JM.forward(jc, p, embeds=e))(
        jp, jnp.asarray(emb))
    got = TM.forward(tc, tp, embeds=torch.as_tensor(emb))
    _rel_close(got, want, 1e-4, "forward logits")


def test_prefill_from_embeddings_then_decode_matches_reference(pair):
    _, jc, jp, tc, tp, emb = pair
    steps = 4
    jl, jcache = jax.jit(functools.partial(JM.prefill, jc, max_seq=T + steps))(
        jp, embeds=jnp.asarray(emb))
    tl, tcache = TM.prefill(tc, tp, embeds=torch.as_tensor(emb),
                            max_seq=T + steps)
    _rel_close(tl, jl, 1e-4, "prefill logits")
    jleaves = jax.tree_util.tree_leaves_with_path(
        _layers(jcache, jc.n_layers))
    tleaves = jax.tree_util.tree_leaves_with_path(tcache["layers"])
    assert len(jleaves) == len(tleaves)
    for (path, a), (_, b) in zip(jleaves, tleaves):
        _rel_close(b, a, 1e-4, f"cache {path}")
    j_tok = jax.jit(lambda p, c, t: JM.decode_step(jc, p, c, token=t))
    j_emb = jax.jit(lambda p, c, e: JM.decode_step(jc, p, c, embed=e))
    rng = np.random.default_rng(2)
    for step in range(steps):
        if step < steps - 1:  # greedy, by token
            nxt = np.asarray(jnp.argmax(jl[..., : jc.vocab], -1)).astype(
                np.int32)
            jl, jcache = j_tok(jp, jcache, jnp.asarray(nxt))
            tl, tcache = TM.decode_step(tc, tp, tcache,
                                        token=torch.as_tensor(nxt))
        else:  # the frontend's next frame/patch
            e = (rng.normal(size=(B, 1, jc.d_model)) * 0.02).astype(
                np.float32)
            jl, jcache = j_emb(jp, jcache, jnp.asarray(e))
            tl, tcache = TM.decode_step(tc, tp, tcache,
                                        embed=torch.as_tensor(e))
        _rel_close(tl, jl, 1e-4, f"decode {step} logits")
    assert int(tcache["pos"]) == int(jcache["pos"]) == T + steps


@pytest.mark.parametrize("which", ["synthetic_frames", "synthetic_patches"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_synthetic_embeddings(which, dtype):
    """(B, T, D) of N(0, 1) * 0.02 in ``dtype`` on the device asked for,
    the same numbers for the same seed; like every entry point that
    creates tensors, the default device is the card."""
    make = getattr(tfront, which)
    a = make(torch.Generator().manual_seed(4), 3, 500, 64, dtype,
             device="cpu")
    b = make(torch.Generator().manual_seed(4), 3, 500, 64, dtype,
             device="cpu")
    assert a.shape == (3, 500, 64) and a.dtype == dtype
    assert a.device.type == "cpu" and torch.equal(a, b)
    assert abs(float(a.float().std()) / 0.02 - 1) < 0.02
    assert abs(float(a.float().mean())) < 1e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(torch.Generator().manual_seed(4), 1, 2, 8)
