"""Open-loop traffic generation for serving under load (the port of
``repro.serving.traffic``, a numpy copy: the same seed gives the same
``Workload``).

The workload is open-loop: arrivals keep coming at the offered rate whether
or not the system keeps up (a closed loop would throttle itself and hide
the queue).  Everything here is **virtual-time first**: an arrival process
emits plain float timestamps (seconds from 0) that the continuous-batching
scheduler replays on its own deterministic timeline — the time plane of
``dist/clock.py``'s ``FakeClock`` pool runs — so a whole load test is a
pure function of its seeds.  Three processes:

* :class:`PoissonArrivals` — memoryless open-loop traffic at a fixed rate;
* :class:`BurstyArrivals`  — a two-state Markov-modulated Poisson process
  (calm/burst phases with exponential dwell times), flash crowds;
* :class:`TraceArrivals`   — replay explicit timestamps.

Prompt and generation lengths come from seedable :class:`LengthDist`
discrete distributions (or :class:`SharedPrefixDist` prompts);
:class:`Workload` composes process + lengths into a stream of
:class:`~repro_torch.serving.engine.Request` objects with ``arrival_s``
stamped.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from .engine import Request

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "BurstyArrivals",
    "TraceArrivals",
    "LengthDist",
    "SharedPrefixDist",
    "Workload",
]


@runtime_checkable
class ArrivalProcess(Protocol):
    """Emits ``n`` arrival timestamps (seconds, non-decreasing, from 0)."""

    def arrival_times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        ...


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Open-loop Poisson arrivals at ``rate`` requests/second."""

    rate: float

    def __post_init__(self):
        if self.rate <= 0.0:
            raise ValueError(f"need rate > 0, got {self.rate}")

    def arrival_times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class BurstyArrivals:
    """Two-state MMPP: exponential dwell in a calm phase at ``rate_calm``,
    then a burst phase at ``rate_burst`` — flash-crowd traffic whose
    *average* rate matches no single Poisson process.

    ``mean_calm_s`` / ``mean_burst_s`` are the expected phase durations.
    """

    rate_calm: float
    rate_burst: float
    mean_calm_s: float
    mean_burst_s: float

    def __post_init__(self):
        if min(self.rate_calm, self.rate_burst) <= 0.0:
            raise ValueError("both phase rates must be > 0")
        if min(self.mean_calm_s, self.mean_burst_s) <= 0.0:
            raise ValueError("both phase dwell times must be > 0")

    def arrival_times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        out: list[float] = []
        t = 0.0
        burst = False
        while len(out) < n:
            rate = self.rate_burst if burst else self.rate_calm
            dwell = rng.exponential(
                self.mean_burst_s if burst else self.mean_calm_s)
            end = t + dwell
            while len(out) < n:
                t += rng.exponential(1.0 / rate)
                if t >= end:
                    t = end  # unused gap dies with the phase (memoryless)
                    break
                out.append(t)
            burst = not burst
        return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class TraceArrivals:
    """Replay explicit timestamps (a production trace or a hand-built
    regression pattern).  ``times`` must be non-decreasing; asking for more
    arrivals than the trace holds is an error, not a silent wrap."""

    times: tuple

    def __post_init__(self):
        ts = [float(t) for t in self.times]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("trace times must be non-decreasing")

    def arrival_times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if n > len(self.times):
            raise ValueError(
                f"trace holds {len(self.times)} arrivals, asked for {n}")
        return np.asarray([float(t) for t in self.times[:n]])


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Discrete length distribution: ``values`` with optional ``probs``
    (uniform when omitted).  Values are drawn with a generator passed in by
    the workload, so streams are reproducible end to end."""

    values: tuple
    probs: tuple | None = None

    def __post_init__(self):
        if not self.values:
            raise ValueError("LengthDist needs at least one value")
        if any(int(v) < 1 for v in self.values):
            raise ValueError(f"lengths must be >= 1, got {self.values}")
        if self.probs is not None:
            if len(self.probs) != len(self.values):
                raise ValueError("probs must match values one-to-one")
            if abs(sum(self.probs) - 1.0) > 1e-9:
                raise ValueError(f"probs must sum to 1, got {sum(self.probs)}")

    @classmethod
    def fixed(cls, value: int) -> "LengthDist":
        return cls(values=(int(value),))

    @property
    def max_value(self) -> int:
        return max(int(v) for v in self.values)

    def sample(self, rng: np.random.Generator) -> int:
        if len(self.values) == 1:
            return int(self.values[0])
        return int(rng.choice(np.asarray(self.values, np.int64),
                              p=self.probs))


@dataclasses.dataclass(frozen=True)
class SharedPrefixDist:
    """Prompt generator with *shared prefixes* — the workload shape prefix
    caching exists for (system prompts, few-shot templates, multi-turn
    histories).

    ``n_families`` distinct prefix token strings of length ``prefix_len``
    are derived from ``seed`` alone; each prompt picks a family by a Zipf
    law over family rank (pmf ∝ (rank+1)^-``zipf_a``, explicitly
    normalized — NOT numpy's unbounded ``rng.zipf`` — so the draw is a
    plain seeded ``rng.choice`` and hit-rates are reproducible), then
    appends a fresh random suffix whose length is drawn from
    ``suffix_len``.  ``zipf_a=0`` degenerates to uniform family reuse;
    larger ``zipf_a`` concentrates traffic on the hottest families, the
    knob a cache-hit-rate sweep turns.
    """

    n_families: int
    prefix_len: int
    suffix_len: LengthDist
    zipf_a: float = 1.0
    vocab: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.n_families < 1:
            raise ValueError(f"need n_families >= 1, got {self.n_families}")
        if self.prefix_len < 1:
            raise ValueError(f"need prefix_len >= 1, got {self.prefix_len}")
        if self.zipf_a < 0.0:
            raise ValueError(f"need zipf_a >= 0, got {self.zipf_a}")

    @property
    def max_value(self) -> int:
        """Longest prompt this distribution can emit (LengthDist duck)."""
        return self.prefix_len + self.suffix_len.max_value

    def _families(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab,
                            size=(self.n_families, self.prefix_len),
                            dtype=np.int64)

    def _pmf(self) -> np.ndarray:
        ranks = np.arange(1, self.n_families + 1, dtype=np.float64)
        w = ranks ** -self.zipf_a
        return w / w.sum()

    def sample_prompt(self, rng: np.random.Generator) -> np.ndarray:
        fam = int(rng.choice(self.n_families, p=self._pmf()))
        suffix_n = self.suffix_len.sample(rng)
        suffix = rng.integers(0, self.vocab, size=suffix_n, dtype=np.int64)
        return np.concatenate([self._families()[fam], suffix])


@dataclasses.dataclass(frozen=True)
class Workload:
    """Arrival process x prompt/generation length distributions -> a
    reproducible open-loop request stream.

    ``generate(n)`` returns ``n`` :class:`Request` objects ordered by
    ``arrival_s``; prompt token ids are drawn uniformly from
    ``[0, vocab)``, or — when ``shared_prefix`` is set — from a
    :class:`SharedPrefixDist` (Zipf-reused prefix families + fresh
    suffixes; ``prompt_len`` is then ignored).  Everything derives from
    ``seed`` alone.
    """

    arrivals: ArrivalProcess
    prompt_len: LengthDist
    max_new: LengthDist
    vocab: int = 256
    seed: int = 0
    shared_prefix: SharedPrefixDist | None = None

    @property
    def max_seq(self) -> int:
        """Longest prompt + generation this workload can emit — what the
        scheduler's shared ring caches must be sized for."""
        prompt = (self.shared_prefix.max_value
                  if self.shared_prefix is not None
                  else self.prompt_len.max_value)
        return prompt + self.max_new.max_value

    def generate(self, n: int) -> list[Request]:
        rng = np.random.default_rng(self.seed)
        times = self.arrivals.arrival_times(n, rng)
        out = []
        for rid in range(n):
            if self.shared_prefix is not None:
                m = self.max_new.sample(rng)
                prompt = self.shared_prefix.sample_prompt(rng)
            else:
                # draw order (T, m, prompt) is pinned by seeded tests —
                # keep it for the uniform path
                T = self.prompt_len.sample(rng)
                m = self.max_new.sample(rng)
                prompt = rng.integers(0, self.vocab, size=T, dtype=np.int64)
            out.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                               max_new=m, arrival_s=float(times[rid])))
        return out
