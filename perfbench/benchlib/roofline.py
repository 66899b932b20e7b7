"""The yardstick: the card's published peaks and the least time of each
operation the traffic issued, computed from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 3.35 TB/s of HBM, 989 TFLOP/s bf16, 495 TFLOP/s TF32.  An
f32 product is held to the TF32 rate, the highest at which this card
multiplies f32 operands (``chip_smoke.py``'s kernel tables use the 67
TFLOP/s SIMT rate; a 3xTF32 main loop would read over 100% of that).

Work is the operation's, not the implementation's: each input byte is
read once and each output byte written once, whatever a kernel reads
again.  ``bound`` is a copy of ``chip_smoke.bound`` with the roof above.
"""
from __future__ import annotations

import dataclasses

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}


def bound(n_bytes: float, flops: float, dtype_name: str
          ) -> tuple[float, str]:
    """(least seconds, what bounds it) for ``n_bytes`` moved and ``flops``
    computed in ``dtype_name``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass(frozen=True)
class Conv:
    """A stride-1 or strided conv over NCHW input of (padded) size
    ``h_in`` x ``w_in``, output width ``w_out`` columns (a piece's slice or
    the whole layer)."""

    batch: int
    c_in: int
    c_out: int
    h_in: int
    w_in: int
    kernel: int
    stride: int = 1

    @property
    def h_out(self) -> int:
        return (self.h_in - self.kernel) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w_in - self.kernel) // self.stride + 1

    def flops(self) -> float:
        return (2.0 * self.batch * self.c_out * self.c_in * self.kernel ** 2
                * self.h_out * self.w_out)

    def bytes(self, item: int = 4) -> float:
        return item * (self.batch * self.c_in * self.h_in * self.w_in
                       + self.c_out * self.c_in * self.kernel ** 2
                       + self.batch * self.c_out * self.h_out * self.w_out)

    def least_s(self, dtype: str = "float32") -> float:
        return bound(self.bytes(), self.flops(), dtype)[0]


def gemm_flops(m: int, k: int, n: int, batch: int = 1) -> float:
    return 2.0 * batch * m * k * n


def stacked_gemm_least_s(lanes: int, t_p: int, d_in: int, d_out: int,
                         item: int = 4, dtype: str = "float32") -> float:
    """``lanes`` piece GEMMs (t_p, d_in) @ (d_in, d_out) sharing one
    weight: each lane's rows read once, the weight once, each output once."""
    flops = gemm_flops(t_p, d_in, d_out, lanes)
    n_bytes = item * (lanes * t_p * d_in + d_in * d_out + lanes * t_p * d_out)
    return bound(n_bytes, flops, dtype)[0]


def width_split(w_out: int, k: int) -> tuple[int, int]:
    """(piece output width, remainder columns) of a conv's output width
    cut into k equal pieces, the rest left to the master."""
    p = w_out // k
    return p, w_out - k * p


def conv_piece(layer: Conv, w_out_p: int) -> Conv:
    """The conv computing ``w_out_p`` output columns of ``layer``: its
    input slice is (w_out_p - 1) * stride + kernel columns wide."""
    return dataclasses.replace(
        layer, w_in=(w_out_p - 1) * layer.stride + layer.kernel)
