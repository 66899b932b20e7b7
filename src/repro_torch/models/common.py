"""Shared model primitives: norms, RoPE, initialisers (the port of
``repro.models.common``)."""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["rms_norm", "rope", "rope_at", "he_init", "lecun_init"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32, cast back to input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding. x: (B, T, H, P); positions: (T,) or (B, T)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    # broadcast to (B, T, 1, half)
    while cos.dim() < x.dim() - 1:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_at(x: torch.Tensor, pos, theta: float = 1e4) -> torch.Tensor:
    """RoPE for one decode step. x: (B, 1, H, P); pos: scalar int, or (B,)
    per-request positions (a continuous batch whose lanes are at different
    sequence depths)."""
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None] if pos.dim() else pos[None]  # (B, 1) | (1,)
    return rope(x, positions, theta)


def he_init(gen: torch.Generator, shape, dtype=torch.bfloat16, fan_in=None,
            *, device: str | torch.device = "cuda") -> torch.Tensor:
    """Normal(0, 2 / fan_in) drawn from ``gen`` on the generator's device,
    moved to ``device``."""
    dev = resolve_device(device)
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    w.mul_((2.0 / fan_in) ** 0.5)  # in place: one f32 copy of the shape
    return w.to(device=dev, dtype=dtype)


def lecun_init(gen: torch.Generator, shape, dtype=torch.bfloat16, fan_in=None,
               *, device: str | torch.device = "cuda") -> torch.Tensor:
    """Normal(0, 1 / fan_in) drawn from ``gen`` on the generator's device,
    moved to ``device``."""
    dev = resolve_device(device)
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    w.mul_((1.0 / fan_in) ** 0.5)  # in place: one f32 copy of the shape
    return w.to(device=dev, dtype=dtype)
