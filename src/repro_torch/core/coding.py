"""Coding schemes for CoCoI (paper §II-B, App. G).

Implements the three redundancy schemes the paper evaluates:

* ``MDSCode``      — (n, k) Vandermonde MDS code (the paper's choice, eq. 3/4).
* ``ReplicationCode`` — 2x replication benchmark [15] (§V, "Replication").
* ``LTCode``       — Luby-Transform rateless code benchmark (App. G, LtCoI).

All schemes expose ``encode`` (k source rows -> n coded rows) and
``decode_from`` (any sufficient subset of coded rows -> k source rows).
Rows are flattened feature vectors, matching the paper's flatten/concat
formulation; callers reshape around them (see splitting.py / coded_conv.py).

Notes on numerics: the paper's Vandermonde nodes are implicitly integers
(1..n).  In f32 the resulting G_S is catastrophically ill-conditioned past
k~8, so we use Chebyshev-spaced nodes in [-1, 1] (any distinct nodes keep
the MDS property: every kxk sub-Vandermonde is invertible).  See
DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "vandermonde_nodes",
    "vandermonde_generator",
    "decode_matrix_cached",
    "MDSCode",
    "ReplicationCode",
    "LTCode",
    "robust_soliton",
    "device_matrix",
    "device_index",
]


# ---------------------------------------------------------------------------
# host matrices on the device
# ---------------------------------------------------------------------------
# Generators and decode matrices stay host-side numpy float64 (cached, and
# equal to the reference's bit for bit).  The data lives on the card, so
# each matrix is uploaded once per (matrix, dtype, device) and kept: without
# this every layer's encode and decode would pay a host-to-device copy and
# the synchronisation that comes with it.  Keys name the matrix (never its
# id), so an evicted numpy array cannot alias a live entry.

_DEVICE_CACHE: dict = {}
_DEVICE_CACHE_MAX = 8192


def device_matrix(key: tuple, make, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``make()`` (a host numpy matrix) as a ``dtype`` tensor on ``device``,
    uploaded once per ``(key, dtype, device)``.  The f64 -> dtype cast
    happens on the host, as the reference casts at each call."""
    full = (key, dtype, str(device))
    t = _DEVICE_CACHE.get(full)
    if t is None:
        if len(_DEVICE_CACHE) >= _DEVICE_CACHE_MAX:
            _DEVICE_CACHE.clear()
        # np.array copies: the cached host matrices are read-only
        t = torch.from_numpy(np.array(make())).to(dtype).to(device)
        _DEVICE_CACHE[full] = t
    return t


def device_index(idx: Sequence[int], device: torch.device) -> torch.Tensor:
    """A gather index as an int64 tensor on ``device``, uploaded once."""
    key = tuple(int(i) for i in idx)
    return device_matrix(("index", key),
                         lambda: np.asarray(key, dtype=np.int64),
                         torch.int64, device)


def vandermonde_nodes(n: int, kind: str = "chebyshev") -> np.ndarray:
    """Evaluation points g_1..g_n for the Vandermonde generator."""
    if kind == "chebyshev":
        # Chebyshev points of the first kind on [-1, 1]: well-conditioned.
        i = np.arange(1, n + 1)
        return np.cos((2 * i - 1) * np.pi / (2 * n))
    if kind == "integer":
        # The textbook construction the paper references [16].
        return np.arange(1, n + 1, dtype=np.float64)
    raise ValueError(f"unknown node kind: {kind}")


@functools.lru_cache(maxsize=512)
def vandermonde_generator(n: int, k: int, kind: str = "chebyshev") -> np.ndarray:
    """The n x k generator G of eq. (3): G[i, j] = g_i^(k-1-j).

    Cached: every (spec, n, k) phase-size evaluation and every encode touches
    the same handful of generators.  The returned array is shared — callers
    must not mutate it.
    """
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got n={n} k={k}")
    g = vandermonde_nodes(n, kind)
    powers = np.arange(k - 1, -1, -1)  # k-1, k-2, ..., 0
    G = np.power.outer(g, powers)  # (n, k)
    G.setflags(write=False)
    return G


@functools.lru_cache(maxsize=4096)
def decode_matrix_cached(n: int, k: int, subset: tuple, kind: str) -> np.ndarray:
    """G_S^{-1} for the k-subset S (eq. 4), cached on (n, k, S, node kind).

    Fastest-k decoding revisits a small set of subsets (the fast workers are
    sticky), so the `np.linalg.inv` per call the seed paid is almost always
    redundant.  DESIGN.md §2.
    """
    G = vandermonde_generator(n, k, kind)
    D = np.linalg.inv(G[np.asarray(subset)])
    D.setflags(write=False)
    return D


@dataclasses.dataclass(frozen=True)
class MDSCode:
    """(n, k) MDS code over f32/f64 with a Vandermonde generator (eq. 3/4)."""

    n: int
    k: int
    node_kind: str = "chebyshev"

    def __post_init__(self):
        if not 1 <= self.k <= self.n:
            raise ValueError(f"need 1 <= k <= n, got n={self.n} k={self.k}")

    @property
    def r(self) -> int:
        """Redundancy r = n - k (tolerated stragglers/failures)."""
        return self.n - self.k

    @property
    def generator(self) -> np.ndarray:
        return vandermonde_generator(self.n, self.k, self.node_kind)

    @property
    def min_done(self) -> int:
        """Fewest worker completions that can possibly decode (any k)."""
        return self.k

    def decodable(self, subset: Sequence[int]) -> bool:
        """MDS property: ANY k distinct in-range coded rows decode."""
        idx = {int(i) for i in subset}
        return all(0 <= i < self.n for i in idx) and len(idx) >= self.k

    def default_subset(self) -> list[int]:
        return list(range(self.k))

    # -- encode -----------------------------------------------------------
    def encode(self, sources: torch.Tensor) -> torch.Tensor:
        """(k, F) source matrix -> (n, F) coded matrix: G @ X  (eq. 3).

        Routed through the skinny-GEMM kernel (kernels/skinny_gemm.py) for a
        CUDA tensor, its plain version for a CPU tensor.
        """
        if sources.shape[0] != self.k:
            raise ValueError(f"expected {self.k} source rows, got {sources.shape[0]}")
        from ..kernels.ops import mds_encode

        G = device_matrix(("mds_g", self.n, self.k, self.node_kind),
                          lambda: self.generator, sources.dtype,
                          sources.device)
        return mds_encode(G, sources)

    # -- decode -----------------------------------------------------------
    def decode_matrix(self, subset: Sequence[int]) -> np.ndarray:
        """G_S^{-1} for the k-subset S of worker indices (eq. 4), cached."""
        subset = tuple(int(i) for i in subset)
        if len(subset) != self.k:
            raise ValueError(f"need exactly k={self.k} indices, got {len(subset)}")
        if len(set(subset)) != self.k:
            raise ValueError("subset indices must be distinct")
        return decode_matrix_cached(self.n, self.k, subset, self.node_kind)

    def decode_from(self, subset: Sequence[int], coded: torch.Tensor
                    ) -> torch.Tensor:
        """Recover (k, F) sources from the coded rows named by ``subset``.

        Any k rows suffice (eq. 4); a larger subset (the pipeline allows
        m > k for rateless schemes) is down-selected to its first k rows.
        The D @ Y GEMM runs through the same skinny-GEMM kernel as the
        encode (kernels/mds_decode.py).
        """
        from ..kernels.ops import mds_decode

        subset = [int(i) for i in subset]
        if len(subset) > self.k:
            # keep the first k DISTINCT rows (decodable() counts distinct
            # indices, so its contract must survive the down-selection)
            keep: list[int] = []
            seen: set[int] = set()
            for pos, idx in enumerate(subset):
                if idx not in seen:
                    seen.add(idx)
                    keep.append(pos)
                if len(keep) == self.k:
                    break
            subset = [subset[p] for p in keep]
            coded = coded.index_select(0, device_index(keep, coded.device))
        D = device_matrix(
            ("mds_d", self.n, self.k, tuple(subset), self.node_kind),
            lambda: self.decode_matrix(subset), coded.dtype, coded.device)
        return mds_decode(D, coded)

    # -- latency-model scaling (eqs. 8, 12) --------------------------------
    def encode_flops(self, row_elems: int) -> int:
        """N^enc = 2 k n F  (eq. 8 with F = B*C_I*H_I*W_I^p)."""
        return 2 * self.k * self.n * row_elems

    def decode_flops(self, row_elems: int) -> int:
        """N^dec = 2 k^2 F  (eq. 12 with F = B*C_O*H_O*W_O^p)."""
        return 2 * self.k * self.k * row_elems


@dataclasses.dataclass(frozen=True)
class ReplicationCode:
    """Replication benchmark [15]: k = floor(n/2) subtasks, each run twice.

    coded row i (i in [n]) is source row i % k; decoding needs one copy of
    every source row.
    """

    n: int

    @property
    def k(self) -> int:
        return max(self.n // 2, 1)

    @property
    def r(self) -> int:
        return self.n - self.k

    def assignment(self) -> np.ndarray:
        """coded row index -> source row index."""
        return np.arange(self.n) % self.k

    @property
    def min_done(self) -> int:
        """Best case: the first k workers cover every source row."""
        return self.k

    def default_subset(self) -> list[int]:
        return list(range(self.k))

    def encode(self, sources: torch.Tensor) -> torch.Tensor:
        if sources.shape[0] != self.k:
            raise ValueError(f"expected {self.k} source rows, got {sources.shape[0]}")
        # a gather, never a 0/1 matrix product: -0.0 must stay -0.0
        return sources.index_select(
            0, device_index(self.assignment(), sources.device))

    def decodable(self, subset: Sequence[int]) -> bool:
        idx = [int(i) for i in subset]
        if not all(0 <= i < self.n for i in idx):
            return False
        return len({i % self.k for i in idx}) == self.k

    def decode_from(self, subset: Sequence[int], coded: torch.Tensor
                    ) -> torch.Tensor:
        """Pick one received copy of each source row."""
        assign = self.assignment()
        chosen: dict[int, int] = {}
        for pos, widx in enumerate(subset):
            src = int(assign[int(widx)])
            chosen.setdefault(src, pos)
        if len(chosen) != self.k:
            raise ValueError("subset does not cover all source rows")
        order = [chosen[s] for s in range(self.k)]
        return coded.index_select(0, device_index(order, coded.device))

    def encode_flops(self, row_elems: int) -> int:
        return 0  # pure copy

    def decode_flops(self, row_elems: int) -> int:
        return 0


def robust_soliton(k: int, c: float = 0.1, delta: float = 0.05) -> np.ndarray:
    """Robust Soliton degree distribution over degrees 1..k (App. G, [17])."""
    if k == 1:
        return np.array([1.0])
    d = np.arange(1, k + 1, dtype=np.float64)
    rho = np.zeros(k)
    rho[0] = 1.0 / k
    rho[1:] = 1.0 / (d[1:] * (d[1:] - 1.0))
    R = c * np.log(k / delta) * np.sqrt(k)
    R = max(R, 1.0)
    tau = np.zeros(k)
    pivot = int(np.floor(k / R))
    pivot = min(max(pivot, 1), k)
    for i in range(1, pivot):
        tau[i - 1] = R / (i * k)
    if pivot >= 1:
        tau[pivot - 1] = R * np.log(R / delta) / k
    dist = rho + tau
    return dist / dist.sum()


@dataclasses.dataclass(frozen=True)
class LTCode:
    """Luby-Transform rateless code (App. G): XOR-style sums of sources.

    Encoded symbol = sum of d uniformly-chosen source symbols, d ~ Robust
    Soliton.  Decoding = Gaussian elimination on the binary encoding matrix;
    ``required`` is stochastic (the paper's n_d).
    """

    k: int
    c: float = 0.1
    delta: float = 0.05

    def sample_encoding_matrix(self, m: int, seed: int) -> np.ndarray:
        """m encoding vectors, each a 0/1 row of length k."""
        rng = np.random.default_rng(seed)
        dist = robust_soliton(self.k, self.c, self.delta)
        rows = np.zeros((m, self.k), dtype=np.float64)
        for i in range(m):
            d = int(rng.choice(np.arange(1, self.k + 1), p=dist))
            idx = rng.choice(self.k, size=d, replace=False)
            rows[i, idx] = 1.0
        return rows

    @staticmethod
    def decodable(rows: np.ndarray, k: int) -> bool:
        return np.linalg.matrix_rank(rows) >= k

    @staticmethod
    def encode_with(rows: np.ndarray, sources: torch.Tensor) -> torch.Tensor:
        E = torch.from_numpy(np.array(rows)).to(sources.dtype).to(
            sources.device)
        return E @ sources

    @staticmethod
    def decode_from(rows: np.ndarray, coded: torch.Tensor) -> torch.Tensor:
        """Minimum-norm least-squares solve (== Gaussian elimination when
        rank is full), as ``jnp.linalg.lstsq`` returns it.

        The pseudo-inverse of the 0/1 ``rows`` is taken on the host in f64
        and applied on ``coded``'s device, so a rank-deficient ``rows``
        gets the minimum-norm solution on every device (``torch.linalg.
        lstsq`` on CUDA has only the full-rank ``gels`` solver).  f32/f64
        ``coded``; :class:`LTScheme` does not come this way, it applies a
        cached pseudo-inverse through the skinny GEMM.
        """
        D = np.linalg.pinv(np.asarray(rows, dtype=np.float64))
        return torch.from_numpy(D).to(coded.dtype).to(coded.device) @ coded
