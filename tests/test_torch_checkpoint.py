"""The port's checkpoints: the reference's layout and keys, bit-for-bit
round trips, and the manifest's own msgpack encoder.

* Saving the same numpy values as a tree of tensors (port) and of jax
  arrays (reference) writes the same ``arrays.npz`` keys in the same
  order and the same ``manifest.msgpack`` bytes, bf16 leaves included
  (the port stores their raw bits as uint16 under the dtype name
  "bfloat16").
* Loading restores every leaf bit for bit, on the ``like`` leaf's device
  and type: f32, bf16, int32, nested dicts, lists and NamedTuples (an
  AdamW state), and a model's parameters with their optimiser state.
* ``latest_step`` finds the newest ``step_<n>`` directory.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.optim import adamw_init as j_adamw_init
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init, tree_leaves


def _numpy_tree(rng):
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"params": {"zeta": a(3), "alpha": [a(2, 2), {"w": a(4),
                                                          "b": a(1)}]},
            "bf": a(5, 3), "count": np.arange(4, dtype=np.int32)}


def _as_torch(tree):
    def conv(path, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if path == "bf" else t
    return {"params": {"zeta": conv("", tree["params"]["zeta"]),
                       "alpha": [conv("", tree["params"]["alpha"][0]),
                                 {k: conv("", v) for k, v in
                                  tree["params"]["alpha"][1].items()}]},
            "bf": conv("bf", tree["bf"]), "count": conv("", tree["count"])}


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["bf"] = out["bf"].astype(jnp.bfloat16)
    return out


def test_layout_keys_and_manifest_equal_the_reference(tmp_path):
    tree = _numpy_tree(np.random.default_rng(0))
    tdir = tck.save_checkpoint(str(tmp_path / "t"), 3, _as_torch(tree))
    jdir = jck.save_checkpoint(str(tmp_path / "j"), 3, _as_jax(tree))
    assert os.path.basename(tdir) == os.path.basename(jdir) == "step_00000003"
    with np.load(os.path.join(tdir, "arrays.npz")) as a, \
            np.load(os.path.join(jdir, "arrays.npz")) as b:
        assert list(a.keys()) == list(b.keys())
        assert "['params']/['alpha']/[1]/['w']" in a.keys()
        for k in a.keys():
            if k == "['bf']":  # the same 16-bit patterns
                assert a[k].dtype == np.uint16 and b[k].itemsize == 2
                np.testing.assert_array_equal(a[k], b[k].view(np.uint16))
            else:
                np.testing.assert_array_equal(a[k], b[k])
    tm = open(os.path.join(tdir, "manifest.msgpack"), "rb").read()
    jm = open(os.path.join(jdir, "manifest.msgpack"), "rb").read()
    assert tm == jm
    assert msgpack.unpackb(tm)["['bf']"] == {"dtype": "bfloat16",
                                             "shape": [5, 3]}


def test_adamw_state_keys_equal_the_reference(tmp_path):
    """A NamedTuple's fields print as ``.step``, ``.mu``, ``.nu``."""
    p = {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}
    tst = adamw_init({k: torch.from_numpy(v) for k, v in p.items()})
    jst = j_adamw_init({k: jnp.asarray(v) for k, v in p.items()})
    tdir = tck.save_checkpoint(str(tmp_path / "t"), 1, {"opt": tst})
    jdir = jck.save_checkpoint(str(tmp_path / "j"), 1, {"opt": jst})
    for name in ("manifest.msgpack",):
        assert open(os.path.join(tdir, name), "rb").read() == \
            open(os.path.join(jdir, name), "rb").read()
    with np.load(os.path.join(tdir, "arrays.npz")) as a:
        assert list(a.keys())[:2] == ["['opt']/.step", "['opt']/.mu/['b']"]


def test_round_trip_is_bit_for_bit(tmp_path):
    cfg = smoke_config("zamba2-1.2b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    for m in tree_leaves(opt.mu):
        m.normal_()
    tree = {"params": params, "opt": opt,
            "half": params["embed"].to(torch.bfloat16),
            "ints": torch.arange(5, dtype=torch.int32)}
    tck.save_checkpoint(str(tmp_path), 12, tree)
    back = tck.load_checkpoint(str(tmp_path), 12, tree)
    assert type(back["opt"]) is type(opt)
    assert isinstance(back["params"]["layers"], list)
    assert list(back["params"]) == list(params)
    for (ka, a), (kb, b) in zip(store._flatten(tree), store._flatten(back)):
        assert ka == kb and a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b), ka
    # loading casts to the like-tree's leaf type
    like = {"params": TM.init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"), "opt": opt,
        "half": params["embed"].float(), "ints": tree["ints"]}
    cast = tck.load_checkpoint(str(tmp_path), 12, like)
    assert cast["half"].dtype == torch.float32
    assert torch.equal(cast["half"], params["embed"].to(torch.bfloat16).float())


def test_latest_step(tmp_path):
    assert tck.latest_step(str(tmp_path / "none")) is None
    assert tck.latest_step(str(tmp_path)) is None
    for s in (2, 10, 7):
        tck.save_checkpoint(str(tmp_path), s, {"a": torch.zeros(1)})
    (tmp_path / "step_x").mkdir()
    assert tck.latest_step(str(tmp_path)) == 10 == \
        jck.latest_step(str(tmp_path))

