"""Tree checkpointing, npz plus a msgpack manifest (the port of
``repro.checkpoint.store``).

Stores nested dict / list / NamedTuple trees of tensors in the reference's
layout: ``<dir>/step_<n>/arrays.npz`` and ``manifest.msgpack``, each leaf
under the key the reference builds from its jax key path
(``"['params']/['layers']/[0]/['norm']"``, ``"['opt']/.mu/..."``), dict
keys in sorted order, and a manifest of ``{key: {"dtype", "shape"}}`` with
the dtype as numpy names it.  numpy has no bfloat16, so a bfloat16 leaf is
stored as its raw 16-bit pattern (``uint16``) under the manifest dtype
``"bfloat16"`` and comes back bit for bit.  msgpack is imported where the
manifest is written or read, never at module import.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _flatten(tree, prefix: str = "") -> list:
    """(key, leaf) pairs in jax's flattening order."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: k)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], join(f"[{k!r}]"))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, join(f"[{i}]"))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are drawn from the iterator
    ``leaves`` in flattening order."""
    if isinstance(like, dict):
        built = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}  # the caller's key order
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree) -> str:
    import msgpack

    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    flat, manifest = {}, {}
    for key, leaf in _flatten(tree):
        a, dtype = _to_numpy(leaf)
        flat[key] = a
        manifest[key] = {"dtype": dtype, "shape": list(a.shape)}
    np.savez(os.path.join(d, "arrays.npz"), **flat)
    with open(os.path.join(d, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    return d


def load_checkpoint(directory: str, step: int, like):
    """Load into the structure of ``like`` (same tree): each leaf takes the
    device and type of ``like``'s leaf at its key."""
    import msgpack

    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in _flatten(like):
            a = data[key]
            if manifest[key]["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            out.append(t)
    return _unflatten(like, iter(out))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None

