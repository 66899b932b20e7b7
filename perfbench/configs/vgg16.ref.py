"""The plain reference of VGG16 as ``configs/vgg16.json`` states it: the
thirteen 3x3 convolutions (zero padding 1, stride 1), ReLU, 2x2 max-pools
and one linear classifier, in float32 with TF32 off, by
``torch.nn.functional`` alone.  No coding, no worker pool, no kernel of
the program: it imports torch and nothing else.

``make_params`` and ``make_inputs`` are how a run makes its weights and
images on the card from its seed; the program and this reference are
handed the same tensors."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def conv_layers(cfg: dict) -> list:
    return [dict(zip(cfg["conv_layer_columns"], row))
            for row in cfg["conv_layers"]]


def head_features(cfg: dict) -> int:
    size = cfg["image"]
    for li in conv_layers(cfg):
        if li["pool_after"]:
            size //= li["pool_after"]
    return conv_layers(cfg)[-1]["c_out"] * size * size


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """He-normal conv weights (OIHW) and a 1/sqrt(features) classifier,
    drawn in one call on ``gen``'s device."""
    K = cfg["kernel"]
    shapes = [(li["c_out"], li["c_in"], K, K) for li in conv_layers(cfg)]
    feat = head_features(cfg)
    shapes.append((feat, cfg["classes"]))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device,
                       dtype=torch.float32)
    leaves = [t.view(s) for t, s in zip(flat.split(sizes), shapes)]
    for w, s in zip(leaves[:-1], shapes[:-1]):
        w.mul_((2.0 / (s[1] * K * K)) ** 0.5)
    leaves[-1].mul_(feat ** -0.5)
    leaves = [t.to(device) for t in leaves]
    return {"convs": leaves[:-1], "head": leaves[-1]}


def make_inputs(cfg: dict, gen: torch.Generator, count: int, device
                ) -> torch.Tensor:
    """``count`` standard-normal images (count, C, H, W), one call."""
    size = cfg["image"]
    x = torch.randn((count, cfg["channels"], size, size), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return x.to(device)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 stored mantissa bits, to nearest), as the
    tensor cores read f32 operands in TF32 mode: the control's precision."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def tf32_off():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@torch.no_grad()
def forward(cfg: dict, params: dict, x: torch.Tensor, *,
            tf32: bool = False) -> torch.Tensor:
    """Logits (B, classes) in float32.  ``tf32=True`` rounds every
    product's operands to TF32 first: the control."""
    q = round_tf32 if tf32 else (lambda t: t)
    pad = cfg["pad"]
    with tf32_off():
        h = x.float()
        for li, w in zip(conv_layers(cfg), params["convs"]):
            h = F.conv2d(q(F.pad(h, (pad,) * 4)), q(w))
            h = F.relu(h)
            if li["pool_after"]:
                h = F.max_pool2d(h, li["pool_after"], li["pool_after"])
        return q(h.reshape(h.shape[0], -1)) @ q(params["head"])
