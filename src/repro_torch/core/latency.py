"""Stochastic latency model of CoCoI (paper §III, App. B).

Every phase latency is shift-exponential (Definition 1):

    F_SE(t; mu, theta, N) = 1 - exp(-(mu/N) (t - N theta)),  t >= N theta

i.e.  T = N*theta + Exp(rate = mu/N), so E[T] = N (theta + 1/mu).
``N`` is the phase scaling (FLOPs for compute phases, bytes for transmission
phases — eqs. 8-12); ``theta`` the minimum per-unit completion time; a
*smaller* ``mu`` means a *stronger* straggling effect.

Order-statistics helpers implement the exponential identities used
throughout §IV:  for n iid Exp(lambda), E[T_(k)] = (H_n - H_{n-k}) / lambda
(exact), which the paper approximates by ln(n/(n-k)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .coding import MDSCode
from .splitting import ConvSpec, plan_width_split

__all__ = [
    "ShiftExp",
    "sizes_for_width",
    "SystemParams",
    "PhaseSizes",
    "phase_sizes",
    "harmonic",
    "exp_order_stat_mean",
    "pipelined_time",
    "stream_chunk_count",
]


def harmonic(n: int) -> float:
    """H_n = sum_{i=1..n} 1/i  (H_0 = 0)."""
    if n <= 0:
        return 0.0
    return float(np.sum(1.0 / np.arange(1, n + 1)))


def pipelined_time(stages, chunks: int) -> float:
    """Virtual duration of a stage chain executed in ``chunks`` column chunks.

    A piece's round trip is a chain of resource stages (receive, per-layer
    compute, send) that serial execution pays as their SUM.  Streaming the
    piece in C equal column chunks pipelines the stages: chunk j's compute
    overlaps chunk j+1's ship, so the chain behaves like a C-deep pipeline
    whose makespan is

        T(C) = sum(stages)/C  +  (C-1) * max(stages)/C

    — the first chunk fills the pipeline (one serial pass at 1/C width),
    then every further chunk costs only the bottleneck stage.  T(1) is the
    serial sum; T(C) -> max(stages) as C grows, i.e. perfect ship/compute
    overlap bounded by the slowest resource (DESIGN.md §11).
    """
    s = [float(x) for x in stages]
    if not s:
        return 0.0
    total = sum(s)
    c = max(int(chunks), 1)
    if c == 1:
        return total
    return total / c + (c - 1) * max(s) / c


def stream_chunk_count(stages, *, tol: float = 0.1, cap: int = 8) -> int:
    """Smallest chunk count within ``tol`` of the pipeline's asymptote.

    ``pipelined_time`` approaches max(stages) as C grows; chunking past
    that point only adds per-chunk overhead.  The smallest C with
    ``T(C) - max <= tol * max`` is ``ceil((sum - max) / (tol * max))`` —
    large when transfer and compute are comparable (lots to overlap),
    1 when one stage dominates (nothing to hide).  Capped at ``cap``.
    """
    import math

    s = [float(x) for x in stages]
    if not s:
        return 1
    total, mx = sum(s), max(s)
    if mx <= 0.0 or total <= mx:
        return 1
    ideal = (total - mx) / (tol * mx)
    return int(min(max(math.ceil(ideal), 1), max(cap, 1)))


def exp_order_stat_mean(n: int, k: int, rate: float) -> float:
    """E[k-th smallest of n iid Exp(rate)] = (H_n - H_{n-k}) / rate (exact)."""
    return (harmonic(n) - harmonic(n - k)) / rate


@dataclasses.dataclass(frozen=True)
class ShiftExp:
    """Shift-exponential distribution F_SE(t; mu, theta, N) (Definition 1)."""

    mu: float
    theta: float

    def scaled(self, N: float) -> "ScaledShiftExp":
        return ScaledShiftExp(self.mu, self.theta, N)


@dataclasses.dataclass(frozen=True)
class ScaledShiftExp:
    mu: float
    theta: float
    N: float

    @property
    def shift(self) -> float:
        return self.N * self.theta

    @property
    def rate(self) -> float:
        return self.mu / self.N

    def mean(self) -> float:
        return self.N * (self.theta + 1.0 / self.mu)

    def cdf(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        return np.where(t >= self.shift, 1.0 - np.exp(-self.rate * (t - self.shift)), 0.0)

    def sample(self, rng: np.random.Generator, size=()) -> np.ndarray:
        return self.shift + rng.exponential(scale=1.0 / self.rate, size=size)

    def order_stat_mean(self, n: int, k: int) -> float:
        """E[k-th smallest among n iid copies] (exact harmonic form)."""
        return self.shift + exp_order_stat_mean(n, k, self.rate)


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Straggling (mu) and shift (theta) coefficients of §III-B.

    Defaults are fitted to the paper's testbed scale (Fig. 8 / App. B):
    Raspberry-Pi 4B ~ 5 GFLOP/s effective conv throughput, ~100 Mbps WiFi.
    mu/theta are per-unit (per-FLOP / per-byte) rates, so e.g.
    theta_cmp = 2e-10 s/FLOP ~ 5 GFLOP/s minimum compute time.
    """

    mu_m: float = 2e10      # master encode/decode straggle (per-FLOP)
    theta_m: float = 1e-10  # master min seconds-per-FLOP
    mu_cmp: float = 2e9     # worker conv straggle
    theta_cmp: float = 2e-10
    mu_rec: float = 5e7     # master->worker transmission (per-byte)
    theta_rec: float = 8e-8  # ~ 100 Mbps
    mu_sen: float = 5e7     # worker->master transmission
    theta_sen: float = 8e-8

    @property
    def master(self) -> ShiftExp:
        return ShiftExp(self.mu_m, self.theta_m)

    @property
    def cmp(self) -> ShiftExp:
        return ShiftExp(self.mu_cmp, self.theta_cmp)

    @property
    def rec(self) -> ShiftExp:
        return ShiftExp(self.mu_rec, self.theta_rec)

    @property
    def sen(self) -> ShiftExp:
        return ShiftExp(self.mu_sen, self.theta_sen)

    def scaled_tr(self, factor: float) -> "SystemParams":
        """Scenario-1 style extra transmission straggling: divide mu_tr."""
        return dataclasses.replace(
            self, mu_rec=self.mu_rec / factor, mu_sen=self.mu_sen / factor
        )


@dataclasses.dataclass(frozen=True)
class PhaseSizes:
    """Scaling parameters N of every phase for a (spec, n, k) choice."""

    n_enc: float  # FLOPs, eq. (8)
    n_cmp: float  # FLOPs, eq. (9)
    n_rec: float  # bytes, eq. (10)
    n_sen: float  # bytes, eq. (11)
    n_dec: float  # FLOPs, eq. (12)


def sizes_for_width(spec: ConvSpec, n: int, k: int, w_o_p: int) -> PhaseSizes:
    """Phase sizes for a subtask of explicit output width ``w_o_p`` (used
    for uneven uncoded splits, where workers get floor/ceil loads)."""
    w_i_p = spec.kernel + (w_o_p - 1) * spec.stride
    row_in = spec.batch * spec.c_in * spec.h_in * w_i_p
    row_out = spec.batch * spec.c_out * spec.h_out * w_o_p
    code = MDSCode(max(n, k), k)
    return PhaseSizes(
        n_enc=code.encode_flops(row_in),
        n_cmp=spec.subtask_flops(w_o_p),
        n_rec=spec.recv_bytes(w_i_p),
        n_sen=spec.send_bytes(w_o_p),
        n_dec=code.decode_flops(row_out),
    )


def phase_sizes(spec: ConvSpec, n: int, k: int) -> PhaseSizes:
    """Evaluate eqs. (8)-(12) for a width-split of ``spec`` into k pieces."""
    plan = plan_width_split(spec, k)
    w_i_p, w_o_p = plan.w_in_p, plan.w_out_p
    row_in = spec.batch * spec.c_in * spec.h_in * w_i_p
    row_out = spec.batch * spec.c_out * spec.h_out * w_o_p
    code = MDSCode(n, k)
    return PhaseSizes(
        n_enc=code.encode_flops(row_in),
        n_cmp=spec.subtask_flops(w_o_p),
        n_rec=spec.recv_bytes(w_i_p),
        n_sen=spec.send_bytes(w_o_p),
        n_dec=code.decode_flops(row_out),
    )
