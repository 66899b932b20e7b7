"""Mamba2 SSD (state-space duality) block — chunked scan + O(1) decode (the
port of ``repro.models.ssm``).

Implements the SSD algorithm of Mamba2 [arXiv:2405.21060] with G=1
(B/C shared across heads):

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t           (per head, state N)
    y_t = C_t . h_t + D x_t

Full sequences use the chunked dual form.  Unlike the reference, whose
``ssd_chunked`` is plain jnp, the port's runs every chunk through the SSD
kernel (``kernels/ssd_chunk.py``): one launch per call on a CUDA tensor,
the plain version on a CPU tensor.  Decode is a single recurrence step on a
carried (B, H, P, N) state, in plain torch as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.ssd_chunk import ssd_chunk_scan
from .common import lecun_init, rms_norm

__all__ = ["SSMDims", "MambaState", "init_mamba_params", "mamba_forward",
           "mamba_step", "init_mamba_state", "ssd_chunked", "ssd_step"]


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int           # N
    expand: int = 2
    head_dim: int = 64     # P
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state  # x, B, C go through the conv

    @property
    def in_proj_dim(self) -> int:
        # z, x, B, C, dt
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


def init_mamba_params(gen: torch.Generator, dims: SSMDims,
                      dtype=torch.bfloat16, *,
                      device: str | torch.device = "cuda") -> dict:
    """The reference's layout and scales; numbers from ``gen`` (not the
    reference's random bits — parity tests carry its parameters across
    with ``repro_torch.convert``)."""
    dev = resolve_device(device)
    H = dims.n_heads
    f32 = torch.float32
    return {
        "in_proj": lecun_init(gen, (dims.d_model, dims.in_proj_dim), dtype,
                              device=dev),
        "conv_w": lecun_init(gen, (dims.conv_dim, dims.conv_width), dtype,
                             fan_in=dims.conv_width, device=dev),
        "conv_b": torch.zeros((dims.conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.full((H,), math.log(math.expm1(1e-2)), dtype=f32,
                              device=dev),
        "gate_norm": torch.zeros((dims.d_inner,), dtype=f32, device=dev),
        "out_proj": lecun_init(gen, (dims.d_inner, dims.d_model), dtype,
                               device=dev),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 128, init_state=None):
    """x (B, T, H, P), dt (B, T, H) positive, A (H,) negative, Bm / Cm
    (B, T, N), init_state (B, H, P, N) or None.  Returns (y: (B, T, H, P)
    in x's dtype, final_state: (B, H, P, N) f32); f32 internals.  A ragged
    last chunk is padded with dt = 0 steps, as in the reference."""
    T = x.shape[1]
    return ssd_chunk_scan(x, dt.float(), A.float(), Bm, Cm, init_state,
                          min(chunk, T))


def ssd_step(state, x, dt, A, Bm, Cm):
    """One recurrence step: state (B, H, P, N) f32, x (B, H, P), dt (B, H),
    A (H,), Bm / Cm (B, N).  Returns (y: (B, H, P), new_state)."""
    x_, dt_, B_, C_ = (t.float() for t in (x, dt, Bm, Cm))
    decay = torch.exp(dt_ * A.float()[None, :])  # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt_, B_, x_)
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, conv_dim, conv_width-1) recent conv inputs
    ssm: torch.Tensor   # (B, H, P, N) f32


def init_mamba_state(dims: SSMDims, batch: int, dtype=torch.bfloat16, *,
                     device: str | torch.device = "cuda") -> MambaState:
    dev = resolve_device(device)
    return MambaState(
        conv=torch.zeros((batch, dims.conv_dim, dims.conv_width - 1),
                         dtype=dtype, device=dev),
        ssm=torch.zeros((batch, dims.n_heads, dims.head_dim, dims.d_state),
                        dtype=torch.float32, device=dev),
    )


def _split_in_proj(zxbcdt: torch.Tensor, dims: SSMDims):
    di, H = dims.d_inner, dims.n_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + dims.conv_dim]
    dt_raw = zxbcdt[..., di + dims.conv_dim:]
    if dt_raw.shape[-1] != H:
        raise ValueError(f"in_proj width {zxbcdt.shape[-1]} does not match "
                         f"{dims}")
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B, T, C); w: (C, W).

    The reference uses ``lax.conv_general_dilated`` (no Pallas); this is
    the same cross-correlation written out over its W taps, summed in f32,
    so no cuDNN algorithm (and no TF32 path) is chosen for it."""
    T = xbc.shape[1]
    W = w.shape[-1]
    pad = F.pad(xbc.float(), (0, 0, W - 1, 0))
    wf = w.float()
    out = pad[:, 0:T] * wf[:, 0]
    for k in range(1, W):
        out = out + pad[:, k: k + T] * wf[:, k]
    return out.to(xbc.dtype) + b.to(xbc.dtype)


def mamba_forward(params: dict, x: torch.Tensor, dims: SSMDims,
                  chunk: int = 128):
    """Full-sequence Mamba2 block. x: (B, T, D) -> (B, T, D), final
    MambaState."""
    Bsz, T, _ = x.shape
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt_raw = _split_in_proj(zxbcdt, dims)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    di, N = dims.d_inner, dims.d_state
    xs = xbc[..., :di].reshape(Bsz, T, dims.n_heads, dims.head_dim)
    Bm = xbc[..., di: di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"])
    y, final_ssm = ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(Bsz, T, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"])
    out = y @ params["out_proj"]
    # conv state: last W-1 *pre-conv* inputs
    zxbcdt_tail = x[:, -(dims.conv_width - 1):] @ params["in_proj"]
    _, xbc_tail, _ = _split_in_proj(zxbcdt_tail, dims)
    state = MambaState(conv=xbc_tail.transpose(1, 2), ssm=final_ssm)
    return out, state


def mamba_step(params: dict, x: torch.Tensor, state: MambaState,
               dims: SSMDims):
    """One-token step. x: (B, 1, D) -> (B, 1, D), new state."""
    Bsz = x.shape[0]
    zxbcdt = x[:, 0] @ params["in_proj"]  # (B, in_proj_dim)
    z, xbc_new, dt_raw = _split_in_proj(zxbcdt, dims)
    # causal conv over [conv_state, new]: take the last output position
    hist = torch.cat([state.conv, xbc_new[..., None]], dim=-1)  # (B, C, W)
    conv_out = torch.einsum("bcw,cw->bc", hist.float(),
                            params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)
    di, N = dims.d_inner, dims.d_state
    xs = conv_out[..., :di].reshape(Bsz, dims.n_heads, dims.head_dim)
    Bm = conv_out[..., di: di + N]
    Cm = conv_out[..., di + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None])
    A = -torch.exp(params["A_log"])
    y, new_ssm = ssd_step(state.ssm, xs, dt, A, Bm, Cm)
    y = y + params["D"].to(y.dtype)[None, :, None] * xs
    y = y.reshape(Bsz, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"])
    out = (y @ params["out_proj"])[:, None]
    new_state = MambaState(conv=hist[..., 1:], ssm=new_ssm)
    return out, new_state
