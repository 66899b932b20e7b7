"""Carry parameters between the JAX reference and this port.

Both packages keep parameters as plain nested dicts in the same layouts, so
conversion is a change of container only: numpy arrays in, tensors on the
requested device out (and back).  The parity tests build parameters with
the reference's ``init_*`` functions, pass them through numpy and run both
packages on the same numpy input.

* CNNs: ``{"convs": [OIHW weight, ...], "head": (features, classes)}``.
* Decoder models (``models/model.py``): the ``init_params`` tree —
  ``layers``, ``final_norm``, ``embed`` and, for hybrids, ``shared_attn``.
  The reference stacks homogeneous layers (one dict whose leaves carry a
  leading layer axis); the port keeps a per-layer list, so a stacked
  ``layers`` is unstacked on the way in.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["cnn_params_from_numpy", "cnn_params_to_numpy",
           "model_params_from_numpy", "model_params_to_numpy"]

# numpy dtype names (bfloat16 arrives as ml_dtypes' type) -> torch dtypes
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64}


def _convs(params: Mapping):
    convs = params["convs"]
    # resnet18_forward hands forward_plan a {position: weight} dict
    return [convs[i] for i in sorted(convs)] if isinstance(convs, Mapping) \
        else list(convs)


def cnn_params_from_numpy(params: Mapping, *,
                          device: str | torch.device = "cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """Reference CNN parameters (numpy arrays, or anything ``np.asarray``
    takes) -> the port's dict of ``dtype`` tensors on ``device``."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
        return t.to(dtype).to(dev)

    convs = [conv(w) for w in _convs(params)]
    for w in convs:
        if w.dim() != 4 or w.shape[2] != w.shape[3]:
            raise ValueError(f"conv weights must be OIHW with a square "
                             f"kernel, got {tuple(w.shape)}")
    head = conv(params["head"])
    if head.dim() != 2:
        raise ValueError(f"head must be (features, classes), got "
                         f"{tuple(head.shape)}")
    return {"convs": convs, "head": head}


def cnn_params_to_numpy(params: Mapping) -> dict:
    """The port's CNN parameters -> float32 numpy arrays in the same dict."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy()

    return {"convs": [arr(w) for w in _convs(params)],
            "head": arr(params["head"])}


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _unstack(layers: Mapping) -> list:
    """A stacked layer dict (leading layer axis on every leaf) -> a list of
    per-layer dicts."""
    probe = layers
    while isinstance(probe, Mapping):
        probe = next(iter(probe.values()))
    n = int(np.shape(probe)[0])
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], layers)
            for i in range(n)]


def model_params_from_numpy(params: Mapping, *,
                            device: str | torch.device = "cuda",
                            dtype: torch.dtype | None = None) -> dict:
    """Reference decoder parameters (numpy or jax arrays) -> the port's
    tree of tensors on ``device``.  Each leaf keeps its own type (bfloat16
    stays bfloat16, float32 stays float32) unless ``dtype`` is given, which
    then applies to every floating leaf."""
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        name = str(a.dtype)
        if name not in _TORCH_DTYPES:
            raise TypeError(f"unsupported parameter dtype {name}")
        tdt = _TORCH_DTYPES[name]
        if name in ("bfloat16", "float16"):
            t = torch.from_numpy(np.array(a, dtype=np.float32))
        else:
            t = torch.from_numpy(np.array(a))  # a copy
        if dtype is not None and t.is_floating_point():
            tdt = dtype
        return t.to(tdt).to(dev)

    if "layers" not in params or "embed" not in params:
        raise ValueError("need an init_params tree with 'layers' and 'embed'")
    tree = dict(params)
    if isinstance(tree["layers"], Mapping):
        tree["layers"] = _unstack(tree["layers"])
    return _tree_map(leaf, tree)


def model_params_to_numpy(params: Mapping) -> dict:
    """The port's decoder parameters -> numpy arrays in the same tree:
    floating leaves as float32 (bfloat16 widens exactly), others as they
    are."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu")
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.numpy()

    return _tree_map(arr, params)
