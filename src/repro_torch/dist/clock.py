"""Pluggable clocks for the distributed executor (DESIGN.md §7).

Two time planes coexist in the pool:

* **wall time** — what ``RealClock`` measures and sleeps on; demos and the
  wall-clock benchmark run here, so early exit at the k-th arrival is a
  *measured* saving, not a modeled one;
* **virtual time** — the deterministic timeline the pool books per worker
  from the :class:`~repro_torch.dist.faults.DelayModel`.  ``FakeClock`` never
  sleeps: worker threads still run the real CUDA/torch compute, but every
  arrival is stamped with its modeled virtual finish time and the master
  merges events in virtual-time order, so tests are bit-reproducible
  regardless of OS scheduling.

``Clock.sleep`` is cancellable: the master aborts stragglers mid-sleep the
moment a decodable subset has arrived.
"""
from __future__ import annotations

import threading
import time
from typing import Protocol, runtime_checkable

# the pipelined-chunk timeline math lives with the rest of the latency
# model (core/latency.py); re-exported here because the pool's time
# bookkeeping is where execution consumes it
from ..core.latency import pipelined_time, stream_chunk_count

__all__ = ["Clock", "RealClock", "FakeClock", "pipelined_time",
           "stream_chunk_count"]


@runtime_checkable
class Clock(Protocol):
    """What the worker pool requires of a time source."""

    #: True -> workers never sleep; arrivals are ordered by modeled time.
    virtual: bool

    def now(self) -> float: ...

    def sleep(self, duration: float,
              cancel: threading.Event | None = None) -> bool:
        """Sleep ``duration`` seconds; return False if cancelled early."""
        ...


class RealClock:
    """Monotonic wall clock; ``sleep`` waits on the cancel event so a
    straggling worker wakes immediately when the master cancels it."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, duration: float,
              cancel: threading.Event | None = None) -> bool:
        if duration <= 0.0:
            return True
        if cancel is None:
            time.sleep(duration)
            return True
        return not cancel.wait(duration)


class FakeClock:
    """Deterministic virtual clock for tests.

    ``now`` returns the high-water mark of virtual time the pool has
    advanced to (via :meth:`advance`); ``sleep`` is a no-op that never
    blocks a thread — durations live purely in the pool's per-worker
    virtual bookkeeping, which is what makes executor tests deterministic.
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, t: float) -> None:
        """Move the clock forward to virtual time ``t`` (never backward)."""
        with self._lock:
            self._now = max(self._now, float(t))

    def sleep(self, duration: float,
              cancel: threading.Event | None = None) -> bool:
        # a true no-op on the clock: durations live purely in the pool's
        # per-worker virtual bookkeeping.  Bumping the shared _now here
        # would let concurrent sleepers race timestamps instead.
        if cancel is not None and cancel.is_set():
            return False
        return True
