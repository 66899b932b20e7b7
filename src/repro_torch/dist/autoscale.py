"""Queue-driven autoscaling of the worker fleet (DESIGN.md §12).

A copy of the reference's ``src/repro/dist/autoscale.py`` over the port's
``WorkerPool``, kept here because the port imports nothing of ``repro``.

The serving scheduler admits from an open-loop arrival queue; when the
fleet is too small the queue grows without bound, and when it is too large
workers idle at full cost.  :class:`Autoscaler` closes that loop with the
signals the system already has — per-step queue depth and the profile
bank's fitted per-worker speeds — under an explicit :class:`CostModel`:
scale up only when the modeled cost of the backlog exceeds the cost of a
worker, drain (never hard-remove — draining loses no work) the slowest
member when the queue has stayed empty.

Scaling n is only half the decision: ``recommend_redundancy`` sizes the
extra coded rows from how many fitted stragglers the fleet currently
carries, reusing the per-scheme ``redundancy_policy`` seam — rateless
schemes absorb the recommendation as extra pieces, MDS as a re-solved
(n, k°).  Decisions are recorded (``decisions``) so benchmarks and the
membership timeline in ``serving/metrics.py`` can show cause and effect.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from .pool import WorkerPool

__all__ = ["CostModel", "ScaleDecision", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Relative prices the scaler trades off: one worker-step of fleet cost
    against one request-step of queueing cost.  queue_cost > worker_cost
    means backlog hurts more than capacity (latency-sensitive serving);
    flip the ratio for batch fleets that tolerate queues."""

    worker_cost: float = 1.0
    queue_cost: float = 4.0

    def __post_init__(self):
        if self.worker_cost <= 0 or self.queue_cost <= 0:
            raise ValueError("costs must be positive")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler step's outcome (joined/drained are worker ids)."""

    t: float
    joined: tuple[int, ...]
    drained: tuple[int, ...]
    n_alive: int
    reason: str


class Autoscaler:
    """EWMA queue-depth tracker + cost-gated join/drain policy.

    ``step(queue_depth, t)`` is called once per scheduler step.  Scale-up
    adds workers when the smoothed backlog above ``target_queue`` costs
    more than the workers that would absorb it; scale-down drains the
    slowest fitted worker (``speeds_fn`` — e.g. the planner bank's
    ``speeds``) after the queue has stayed empty.  ``cooldown_steps``
    separates consecutive actions so one burst cannot thrash the fleet.
    """

    def __init__(self, pool: WorkerPool, *, min_workers: int = 1,
                 max_workers: int = 16, target_queue: float = 2.0,
                 alpha: float = 0.5, cooldown_steps: int = 2,
                 cost: CostModel | None = None,
                 speeds_fn: Callable[[int], Sequence[float]] | None = None):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"need 0 < alpha <= 1, got {alpha}")
        self.pool = pool
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.target_queue = float(target_queue)
        self.alpha = float(alpha)
        self.cooldown_steps = int(cooldown_steps)
        self.cost = cost if cost is not None else CostModel()
        self.speeds_fn = speeds_fn
        self.q_hat = 0.0
        self.decisions: list[ScaleDecision] = []
        self._since_action = self.cooldown_steps  # first step may act

    def step(self, queue_depth: int, t: float) -> ScaleDecision:
        """Observe one step's queue depth; join/drain workers as the cost
        model dictates.  Returns the (possibly empty) decision."""
        self.q_hat = ((1.0 - self.alpha) * self.q_hat
                      + self.alpha * float(queue_depth))
        self._since_action += 1
        alive = self.pool.alive_workers()
        joined: tuple[int, ...] = ()
        drained: tuple[int, ...] = ()
        reason = "hold"
        if self._since_action > self.cooldown_steps:
            backlog = self.q_hat - self.target_queue
            if (backlog > 0.0 and len(alive) < self.max_workers
                    and self.cost.queue_cost * backlog
                    >= self.cost.worker_cost):
                want = min(self.max_workers - len(alive),
                           max(1, math.ceil(backlog
                                            / max(self.target_queue, 1.0))))
                joined = tuple(self.pool.add_worker() for _ in range(want))
                reason = (f"backlog q̂={self.q_hat:.2f} > "
                          f"target={self.target_queue:g}")
                self._since_action = 0
            elif (self.q_hat < 0.5 and queue_depth == 0
                  and len(alive) > self.min_workers):
                drained = (self._slowest(alive),)
                self.pool.drain(drained[0])
                reason = f"idle q̂={self.q_hat:.2f}"
                self._since_action = 0
        dec = ScaleDecision(float(t), joined, drained,
                            len(self.pool.alive_workers()), reason)
        self.decisions.append(dec)
        return dec

    def _slowest(self, alive: Sequence[int]) -> int:
        """The drain victim: slowest by fitted speed, highest id on ties
        (joiners go first — they hold the least warmed-up state)."""
        if self.speeds_fn is None:
            return max(alive)
        sp = list(self.speeds_fn(max(alive) + 1))
        return min(alive, key=lambda w: (sp[w], -w))

    def recommend_redundancy(self, speeds: Sequence[float]) -> int:
        """Extra coded rows to carry: one per fitted straggler (speed under
        half the fleet median) plus one for churn headroom — the scheme
        turns this into its own (n, k) via ``redundancy_policy``."""
        sp = [float(s) for s in speeds]
        if not sp:
            return 1
        med = sorted(sp)[len(sp) // 2]
        stragglers = sum(1 for s in sp if s < 0.5 * med)
        return stragglers + 1
