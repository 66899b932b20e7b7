"""BEYOND-PAPER extension: heterogeneous-worker coded inference.

The paper's conclusion names "optimiz[ing] the subtask allocation across
heterogeneous workers" as future work.  With an MDS code the coded pieces
are interchangeable, so heterogeneity is handled by giving fast workers
MORE pieces rather than BIGGER pieces (which would break the equal-size
requirement of eq. 3):

  * split into k source pieces as usual (eqs. 1-2);
  * generate n' >= k coded pieces with an (n', k) Vandermonde code;
  * assign c_i pieces to worker i, sum(c_i) = n', proportionally to its
    measured service rate;
  * decode at the k-th piece arrival, regardless of origin.

``allocate_pieces`` is the planner (largest-remainder proportional with a
>=0 floor), ``simulate_hetero`` the per-trial latency model where worker i
executes its pieces back-to-back after one input transmission.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .latency import SystemParams, phase_sizes
from .splitting import ConvSpec

__all__ = ["allocate_pieces", "simulate_hetero", "worker_speed"]


def worker_speed(p: SystemParams) -> float:
    """Effective per-FLOP service rate of a worker (compute path only)."""
    return 1.0 / (p.theta_cmp + 1.0 / p.mu_cmp)


def allocate_pieces(speeds: Sequence[float], n_pieces: int) -> list[int]:
    """Proportional piece counts per worker (largest remainder method).

    Raises ``ValueError`` on NaN/inf/negative speeds or an all-zero fleet —
    a silent NaN->int cast here used to return INT64_MIN piece counts that
    the executor would only trip over much later.
    """
    speeds = np.asarray(speeds, dtype=np.float64)
    if speeds.size == 0:
        raise ValueError("need at least one worker speed")
    if not np.all(np.isfinite(speeds)) or np.any(speeds < 0):
        raise ValueError(f"speeds must be finite and >= 0, got {speeds.tolist()}")
    if speeds.sum() <= 0.0:
        raise ValueError(
            f"total worker speed must be positive, got {speeds.tolist()}")
    share = speeds / speeds.sum() * n_pieces
    base = np.floor(share).astype(int)
    rem = n_pieces - int(base.sum())
    order = np.argsort(-(share - base))
    base[order[:rem]] += 1
    return base.tolist()


def simulate_hetero(
    spec: ConvSpec,
    k: int,
    assignment: Sequence[int],
    worker_params: Sequence[SystemParams],
    rng: np.random.Generator,
    master: SystemParams | None = None,
) -> float:
    """One trial of heterogeneous coded execution; returns latency.

    Worker i receives its inputs once (c_i pieces in one message), then
    executes its pieces sequentially, sending each back as it finishes.
    The master decodes at the k-th piece arrival overall.
    """
    master = master or worker_params[0]
    n_pieces = int(sum(assignment))
    assert n_pieces >= k, (assignment, k)
    s = phase_sizes(spec, max(n_pieces, k), k)
    arrivals = []
    for c_i, p in zip(assignment, worker_params):
        if c_i == 0:
            continue
        rec = p.rec.scaled(s.n_rec * c_i).sample(rng)
        t = rec
        for _ in range(c_i):
            t = t + p.cmp.scaled(s.n_cmp).sample(rng)
            arrivals.append(t + p.sen.scaled(s.n_sen).sample(rng))
    arrivals.sort()
    t_exec = arrivals[k - 1]
    # s.n_enc (eq. 8) is 2*k*n'*row_in — it already scales with the piece
    # count n', so it is charged as-is; rescaling by the *worker* count
    # over-counted encode work whenever workers held more than one piece
    t_enc = master.master.scaled(s.n_enc).sample(rng)
    t_dec = master.master.scaled(s.n_dec).sample(rng)
    rem = spec.w_out % k
    t_rem = (master.cmp.scaled(spec.subtask_flops(rem)).sample(rng)
             if rem else 0.0)
    return float(t_enc + max(t_exec, t_rem) + t_dec)
