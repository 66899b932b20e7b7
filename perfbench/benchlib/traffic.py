"""The general traffic generator: every mix is a JSON file of parameters
under ``perfbench/traffic/`` that this module reads.

Two kinds:

* ``closed`` — ``clients`` callers, each sending its next request of
  ``batch`` items the moment the last one is answered.  The generator
  gives each request's input index; the driver times the loop.
* ``open`` — ``requests_per_s * seconds`` requests arrive on a Poisson
  schedule at ``rate`` whether or not the system keeps up.  Every seed
  offers the same work: the prompt and output lengths (``LengthDist``, a
  copy of ``repro_torch.serving.traffic``'s) are apportioned to their
  probabilities exactly, and the inter-arrival gaps are the exponential
  distribution's quantiles; the seed only shuffles them and draws the
  token ids.  So two seeds differ in the order of the same requests, not
  in how much there is to do.  A ``rate`` above what the system sustains,
  with about a window's worth of work in the count, keeps the queue from
  emptying before the last request is served.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = ["OpenRequest", "LengthDist", "open_loop", "closed_loop_inputs",
           "apportion"]


@dataclasses.dataclass(frozen=True)
class OpenRequest:
    rid: int
    prompt: np.ndarray      # (T,) int32 token ids
    max_new: int
    arrival_s: float


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Discrete lengths ``values`` with ``probs`` (uniform when omitted)."""

    values: tuple
    probs: tuple | None = None

    def __post_init__(self):
        if not self.values or any(int(v) < 1 for v in self.values):
            raise ValueError(f"lengths must be >= 1, got {self.values}")
        if self.probs is not None and (
                len(self.probs) != len(self.values)
                or abs(sum(self.probs) - 1.0) > 1e-9):
            raise ValueError("probs must match values and sum to 1")

    @classmethod
    def from_json(cls, d: dict) -> "LengthDist":
        if "range" in d:
            lo, hi = d["range"]
            return cls(tuple(range(int(lo), int(hi) + 1)))
        probs = d.get("probs")
        return cls(tuple(int(v) for v in d["values"]),
                   None if probs is None else tuple(float(p) for p in probs))

    @property
    def max_value(self) -> int:
        return max(int(v) for v in self.values)

    @property
    def pmf(self) -> np.ndarray:
        if self.probs is None:
            return np.full(len(self.values), 1.0 / len(self.values))
        return np.asarray(self.probs, np.float64)


def apportion(n: int, pmf: Sequence[float]) -> np.ndarray:
    """Counts summing to ``n`` in proportion to ``pmf`` (largest
    remainders, ties to the earlier value)."""
    pmf = np.asarray(pmf, np.float64)
    raw = pmf * n
    counts = np.floor(raw).astype(np.int64)
    order = np.argsort(-(raw - counts), kind="stable")
    counts[order[: n - int(counts.sum())]] += 1
    return counts


def _fixed_lengths(dist: LengthDist, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    counts = apportion(n, dist.pmf)
    vals = np.repeat(np.asarray(dist.values, np.int64), counts)
    return rng.permutation(vals)


def _fixed_gaps(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """The exponential(rate) quantiles at (i + 0.5) / n, scaled to a mean
    of exactly 1 / rate, in an order drawn from ``rng``."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= n / rate / gaps.sum()
    return rng.permutation(gaps)


def open_loop(traffic: dict, seconds: float, seed: int, vocab: int
              ) -> list[OpenRequest]:
    """The requests an open-loop mix sends in ``seconds``, ordered by
    arrival.  Everything derives from ``seed``."""
    if traffic["kind"] != "open":
        raise ValueError(f"not an open-loop mix: {traffic['kind']!r}")
    rng = np.random.default_rng([int(seed), 0x0BE7])
    prompt = LengthDist.from_json(traffic["prompt_len"])
    new = LengthDist.from_json(traffic["max_new"])
    arr = traffic["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    rate = float(arr["rate"])
    n = max(1, int(round(float(traffic["requests_per_s"]) * seconds)))
    gaps = _fixed_gaps(rate, n, rng)
    times = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    lens = _fixed_lengths(prompt, n, rng)
    news = _fixed_lengths(new, n, rng)
    out = []
    for i in range(n):
        ids = rng.integers(0, vocab, size=int(lens[i]), dtype=np.int64)
        out.append(OpenRequest(i, ids.astype(np.int32), int(news[i]),
                               float(times[i])))
    return out


def closed_loop_inputs(traffic: dict, n_requests: int, seed: int
                       ) -> np.ndarray:
    """Which of the mix's ``distinct_inputs`` input batches each of
    ``n_requests`` closed-loop requests sends: every batch in turn, in an
    order drawn from ``seed``."""
    if traffic["kind"] != "closed":
        raise ValueError(f"not a closed-loop mix: {traffic['kind']!r}")
    rng = np.random.default_rng([int(seed), 0xC105])
    p = int(traffic["distinct_inputs"])
    reps = math.ceil(n_requests / p)
    return np.concatenate([rng.permutation(p) for _ in range(reps)]
                          )[:n_requests]
