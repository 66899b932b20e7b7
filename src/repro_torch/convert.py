"""Carry CNN parameters between the JAX reference and this port.

Both packages keep parameters as a plain dict
``{"convs": [OIHW weight, ...], "head": (features, classes)}`` in the same
layouts, so conversion is a change of container only: numpy arrays in,
tensors on the requested device out (and back).  The parity tests build
parameters with the reference's ``init_*`` functions, pass them through
numpy and run both packages on the same numpy input.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["cnn_params_from_numpy", "cnn_params_to_numpy"]


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
