"""Training in the port against the reference: the loss, one train step of
every architecture, microbatching, per-layer remat and the training loop.

* ``cross_entropy`` equals the reference's within 4 f32 unit roundoffs
  of the loss (relative).
* One ``make_train_step`` call on each of the ten smoke configs, from the
  reference's parameters and an AdamW state with nonzero moments carried
  across with ``repro_torch.convert`` (step 3, the cosine or WSD schedule
  at step 5), on the same numpy batch: the loss within 1e-5 (relative),
  the new moments within 1e-4 of their largest magnitude (they are the
  gradients' f32 sums at other orders, ~10^3 terms of 2^-24) and the new
  parameters within 1e-3 x lr of the reference's.  An update's error is
  lr times its direction's, m / sqrt(v), and with the carried second
  moments (~1e-3) the direction amplifies a gradient's error at most ~4x.
* ``microbatches=4`` takes the same step as the full batch: the loss
  within 1e-5 and the new moments (0.1 x the gradient, a mean of four
  means) within 1e-4 of their largest magnitude.  The parameters are not
  compared: from zero moments the first direction is g / |g|, whose sign
  flips on gradients near 0.
* ``remat=True`` (``torch.utils.checkpoint`` per layer) takes the same
  step as ``remat=False`` bit for bit on the CPU.
* ``train_loop`` lowers the loss, as the reference's
  ``tests/test_system.py::test_loss_improves`` asks of its own, and
  defaults to the GPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import U32, as_np
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import AdamWState as JState
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main, train_loop
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init, tree_leaves

B, T, LR, STEP = 2, 8, 1e-3, 5


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 300)).astype(np.float32) * 4
    logits[..., 290:] = -1e30  # the padded vocab rows
    labels = rng.integers(0, 290, (3, 7)).astype(np.int32)
    want = float(jsteps.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    got = tsteps.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 4 * U32 * abs(want)


def _batch(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, T)).astype(np.int32)
    if cfg.frontend != "none":
        emb = (rng.standard_normal((b, T, cfg.d_model)).astype(np.float32)
               * 0.05)
        return {"embeds": emb, "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab, (b, T)).astype(np.int32),
            "labels": labels}


def _unstacked(params):
    """The reference's tree with a stacked ``layers`` as a per-layer list
    (the port's tree), as numpy."""
    tree = jax.tree.map(np.asarray, dict(params))
    if isinstance(tree["layers"], dict):
        tree["layers"] = convert._unstack(tree["layers"])
    return tree


def _close(got, want, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = as_np(g), as_np(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = float(np.abs(g.astype(np.float64) - w).max())
        lim = atol(w)
        assert err <= lim, f"{what} leaf {i}: err {err:.3g} > {lim:.3g}"


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    cfg = jconfigs.smoke_config(arch)
    return jax.jit(jsteps.make_train_step(cfg, base_lr=LR, total_steps=100))


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_train_step_matches_reference(arch):
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                      * 1e-3, jp)
    nu = jax.tree.map(lambda a: np.abs(rng.normal(size=a.shape)).astype(
        np.float32) * 1e-3, jp)
    jstate = JState(step=jnp.asarray(3, jnp.int32),
                    mu=jax.tree.map(jnp.asarray, mu),
                    nu=jax.tree.map(jnp.asarray, nu))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    tstate = convert.adamw_state_from_numpy(jstate, device="cpu")
    batch = _batch(jc, 3)
    jp2, jst2, jloss = _jax_step(arch)(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(STEP, jnp.int32))
    step = tsteps.make_train_step(tc, base_lr=LR, total_steps=100)
    tp2, tst2, tloss = step(tp, tstate,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, STEP)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert int(tst2.step) == int(jst2.step) == 4
    want = jax.tree.leaves(_unstacked(jp2))
    _close(tree_leaves(tp2), want, lambda w: 1e-3 * LR + 4 * U32 *
           float(np.abs(w).max()), "params")
    got = convert.adamw_state_to_numpy(tst2)
    for name in ("mu", "nu"):
        want = jax.tree.leaves(_unstacked(getattr(jst2, name)))
        _close(jax.tree.leaves(got[name]), want,
               lambda w: 1e-4 * float(np.abs(w).max()) + 1e-30, name)


def _port_step(cfg, seed, microbatches=1, b=4):
    params = TM.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed, b).items()}
    step = tsteps.make_train_step(cfg, base_lr=LR, total_steps=100,
                                  microbatches=microbatches)
    return step(params, adamw_init(params), batch, STEP)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b"])
def test_microbatches_take_the_full_batch_step(arch):
    cfg = tconfigs.smoke_config(arch)
    p1, s1, l1 = _port_step(cfg, 6)
    p4, s4, l4 = _port_step(cfg, 6, microbatches=4)
    assert abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1))
    for name in ("mu", "nu"):
        _close(tree_leaves(getattr(s4, name)),
               tree_leaves(getattr(s1, name)),
               lambda w: 1e-4 * float(np.abs(w).max()) + 1e-30, name)
    with pytest.raises(ValueError, match="microbatches"):
        _port_step(cfg, 6, microbatches=3)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b"])
def test_remat_takes_the_same_step_bit_for_bit(arch):
    cfg = tconfigs.smoke_config(arch)
    p0, s0, l0 = _port_step(cfg, 8, b=2)
    p1, s1, l1 = _port_step(dataclasses.replace(cfg, remat=True), 8, b=2)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves((p0, s0.mu, s0.nu)),
                    tree_leaves((p1, s1.mu, s1.nu))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b"])
def test_train_loop_lowers_the_loss(arch, tmp_path):
    cfg = tconfigs.smoke_config(arch)
    params, losses = train_loop(cfg, steps=12, batch=2, seq=32,
                                log_every=100, device="cpu",
                                ckpt_dir=str(tmp_path))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert (tmp_path / "step_00000012" / "arrays.npz").is_file()
    assert all(not p.requires_grad for p in tree_leaves(params))


def test_train_entry_point_defaults_to_the_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(tconfigs.smoke_config("gemma-2b"), steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--arch", "gemma-2b", "--steps", "1"])
    assert train_main(["--arch", "gemma-2b", "--device", "cpu", "--steps",
                       "12", "--batch", "2", "--seq", "32"]) == 0
    assert "loss:" in capsys.readouterr().out
