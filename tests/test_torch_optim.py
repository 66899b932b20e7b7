"""The port's AdamW and learning-rate schedules against the reference's.

The same numpy trees (nested dicts and lists, f32 and bf16 leaves) and
moments go through ``repro.optim.adamw_update`` and
``repro_torch.optim.adamw_update`` at a grid of steps, learning rates and
hyper-parameters.  Both compute elementwise in f32 with the same
expression, so each new value is within 4 f32 unit roundoffs of the
reference's (relative, plus 1e-30), or one bf16 rounding step for a bf16
parameter (the two may round a near-tie apart).  The schedules agree
within 3e-10 (a few f32 roundings of rates <= 2e-3) at every step of their
warmup, plateau, decay and tail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import U16, U32, as_np
from repro import optim as jopt
from repro_torch import optim as topt


def _tree(rng, dtype="float32"):
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": a(6, 5), "layers": [{"a": a(4), "b": a(3, 2)},
                                     {"a": a(4), "b": a(3, 2)}],
            "emb": (a(7, 3) if dtype == "float32"
                    else a(7, 3).astype(jnp.bfloat16).astype(np.float32))}


def _t(tree, bf16_key=None):
    def conv(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if k == bf16_key else t
    return {k: ([{kk: conv(kk, vv) for kk, vv in x.items()} for x in v]
                if isinstance(v, list) else conv(k, v))
            for k, v in tree.items()}


def _j(tree, bf16_key=None):
    return jax.tree.map(lambda v: jnp.asarray(v), tree) if bf16_key is None \
        else {k: (jnp.asarray(v).astype(jnp.bfloat16) if k == bf16_key
                  else jax.tree.map(jnp.asarray, v)) for k, v in tree.items()}


def _close(got, want, rel, what):
    got = np.asarray(as_np(got), np.float64)
    want = np.asarray(as_np(want), np.float64)
    lim = rel * np.abs(want) + 1e-30
    bad = np.abs(got - want) > lim
    assert not bad.any(), (what, float((np.abs(got - want) / lim).max()))


@pytest.mark.parametrize("step0,lr,wd,b1,b2", [
    (0, 1e-3, 0.1, 0.9, 0.95),
    (3, 3e-4, 0.0, 0.9, 0.999),
    (41, 2e-2, 0.5, 0.8, 0.95),
    (999, 1e-4, 0.1, 0.9, 0.95),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference(step0, lr, wd, b1, b2, bf16):
    rng = np.random.default_rng(step0 + int(bf16))
    params, grads = _tree(rng, "bfloat16" if bf16 else "float32"), _tree(rng)
    mu = _tree(rng)
    nu = jax.tree.map(lambda v: np.abs(v) * 1e-2, _tree(rng))
    key = "emb" if bf16 else None
    jstate = jopt.AdamWState(step=jnp.asarray(step0, jnp.int32),
                             mu=_j(mu), nu=_j(nu))
    tstate = topt.AdamWState(step=torch.tensor(step0, dtype=torch.int32),
                             mu=_t(mu), nu=_t(nu))
    kw = dict(b1=b1, b2=b2, weight_decay=wd)
    jp, js = jopt.adamw_update(_j(params, key), _j(grads), jstate,
                               jnp.asarray(lr, jnp.float32), **kw)
    tparams = _t(params, key)
    tp, ts = topt.adamw_update(tparams, _t(grads), tstate, lr, **kw)
    assert tp is tparams  # updated in place
    assert int(ts.step) == int(js.step) == step0 + 1
    for a, b, c in zip(topt.tree_leaves(tp), jax.tree.leaves(jp),
                       jax.tree.leaves(_j(params, key))):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32)
        _close(a, b, 2 * U16 if a.dtype == torch.bfloat16 else 4 * U32,
               "param")
    for a, b in zip(topt.tree_leaves(ts.mu) + topt.tree_leaves(ts.nu),
                    jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
        assert a.dtype == torch.float32
        _close(a, b, 4 * U32, "moment")


def test_adamw_init_mirrors_the_tree():
    params = _t(_tree(np.random.default_rng(0)), "emb")
    st = topt.adamw_init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for p, m, v in zip(topt.tree_leaves(params), topt.tree_leaves(st.mu),
                       topt.tree_leaves(st.nu)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any() and not v.any() and m is not v
    assert isinstance(st.mu["layers"], list)


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_schedule(1e-3, warmup=10, total=100),
    lambda m: m.cosine_schedule(3e-4, warmup=0, total=10),
    lambda m: m.wsd_schedule(1e-3, warmup=10, stable=80, decay=10),
    lambda m: m.wsd_schedule(2e-3, warmup=1, stable=89, decay=10,
                             floor=0.2),
])
def test_schedules_match_reference(make):
    j, t = make(jopt), make(topt)
    for step in list(range(0, 120, 3)) + [9, 10, 11, 89, 90, 91, 99, 100]:
        a, b = t(step), j(step)
        assert a.dtype == torch.float32 and a.dim() == 0
        assert abs(float(a) - float(b)) <= 1e-7 * 3e-3, (step, a, b)
        assert abs(float(t(torch.tensor(step))) - float(a)) == 0.0
