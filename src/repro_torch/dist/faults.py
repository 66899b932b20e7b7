"""Fault injection + per-piece delay models for the executor (DESIGN.md §7).

A :class:`FaultPlan` scripts the §V scenarios onto a live pool run:

* ``straggler``     — per-worker slowdown multipliers (scenario 3: one
  worker's compute straggles 10x);
* ``dead``          — workers that fail before completing anything
  (scenario 2: device failure at dispatch);
* ``fail_at_piece`` — worker dies when *starting* its i-th piece of the
  run, after completing i pieces (mid-inference failure).

Failure semantics match ``core/runtime.py``: a failed worker signals the
master at the moment it *would have completed* the piece it died on
(detection time), and the master re-dispatches its unfinished pieces to
live workers.

A :class:`DelayModel` maps (worker, piece) to a modeled round-trip
duration in seconds.  ``None`` means "measured mode": the real compute
time of the piece is the duration (wall-clock runs).  In measured mode a
failed piece's would-be completion is unknowable (it never computes), so
detection is effectively immediate — give the pool a DelayModel when the
detection latency itself is under study.  The models are deterministic in
(seed, worker, piece) — independent of thread interleaving — which is
what the FakeClock tests rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.latency import PhaseSizes, SystemParams
from .clock import pipelined_time

__all__ = [
    "FaultPlan",
    "StragglerDrift",
    "ChurnEvent",
    "ChurnSchedule",
    "DelayModel",
    "DeterministicDelay",
    "ShiftExpDelay",
    "SegmentDelay",
    "LayerSlowdown",
    "per_layer_sizes",
]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Scripted faults for one pool run (empty plan = fault-free)."""

    straggler: Mapping[int, float] = dataclasses.field(default_factory=dict)
    dead: frozenset = frozenset()
    fail_at_piece: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def slowdown(self, worker: int) -> float:
        return float(self.straggler.get(worker, 1.0))

    def fails_at(self, worker: int) -> int | None:
        """Local piece index at which ``worker`` dies, or None (never)."""
        if worker in self.dead:
            return 0
        return self.fail_at_piece.get(worker)


@dataclasses.dataclass(frozen=True)
class StragglerDrift:
    """Piecewise straggler schedule across a *sequence* of pool runs.

    One :class:`FaultPlan` scripts a single run; real capacities drift
    over minutes (the paper's "time-varying and possibly unknown" premise,
    §I).  ``phases`` is an ordered tuple of ``(first_request, FaultPlan)``
    pairs; :meth:`plan_at` returns the plan governing request ``i`` —
    fault-free before the first phase.  The adaptive-replanning benchmark
    (benchmarks/adaptive_replan.py) drives its drifting-straggler scenario
    through this.
    """

    phases: tuple = ()

    def __post_init__(self):
        firsts = [int(f) for f, _ in self.phases]
        if firsts != sorted(firsts):
            raise ValueError(f"phases must be ordered by first_request, "
                             f"got starts {firsts}")

    def plan_at(self, request: int) -> FaultPlan:
        plan = FaultPlan()
        for first, phase_plan in self.phases:
            if request >= int(first):
                plan = phase_plan
        return plan


CHURN_ACTIONS = ("join", "remove", "drain")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One scripted membership change at virtual time ``t``.

    ``join`` adds a brand-new worker (``worker`` must be None — the pool
    assigns the next id); ``remove`` is a permanent departure, treated as a
    failure for in-flight pieces; ``drain`` stops new dispatches to the
    worker while everything already queued on it completes.
    """

    t: float
    action: str
    worker: int | None = None

    def __post_init__(self):
        if self.action not in CHURN_ACTIONS:
            raise ValueError(f"action must be one of {CHURN_ACTIONS}, "
                             f"got {self.action!r}")
        if self.t < 0.0:
            raise ValueError(f"need t >= 0, got {self.t}")
        if self.action == "join" and self.worker is not None:
            raise ValueError("join events name no worker: the pool assigns "
                             "the next id at application time")
        if self.action != "join" and self.worker is None:
            raise ValueError(f"{self.action} needs a worker id")


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """Deterministic membership script for an elastic pool (DESIGN.md §12).

    ``events`` is a time-ordered tuple of :class:`ChurnEvent`; the executor
    (``CodedExecutor.run_elastic``) applies them onto one run's virtual
    timeline, and the serving scheduler applies them at step boundaries
    (an event fires at the first step whose start time reaches ``t``).
    Like :class:`FaultPlan`, a schedule is pure data — applying the same
    schedule to the same seeds replays the same run bit-for-bit.
    """

    events: tuple = ()

    def __post_init__(self):
        evs = tuple(self.events)
        ts = [e.t for e in evs]
        if ts != sorted(ts):
            raise ValueError(f"events must be time-ordered, got ts={ts}")
        object.__setattr__(self, "events", evs)

    def __add__(self, other: "ChurnSchedule") -> "ChurnSchedule":
        merged = sorted(self.events + other.events,
                        key=lambda e: (e.t, e.action, e.worker or -1))
        return ChurnSchedule(tuple(merged))

    def until(self, t: float) -> tuple:
        """Events with event-time <= t (the scheduler's step-boundary cut)."""
        return tuple(e for e in self.events if e.t <= t)

    @staticmethod
    def flash_crowd(t: float, n_join: int) -> "ChurnSchedule":
        """``n_join`` fresh workers commissioned at once (scale-out burst)."""
        return ChurnSchedule(tuple(ChurnEvent(t, "join")
                                   for _ in range(n_join)))

    @staticmethod
    def rolling_restart(workers: Sequence[int], t0: float, *,
                        down_s: float, stagger_s: float) -> "ChurnSchedule":
        """Restart ``workers`` one at a time: each is removed (a restarted
        device loses its resident state, so it departs permanently) and a
        replacement joins ``down_s`` later; consecutive restarts start
        ``stagger_s`` apart."""
        evs = []
        for i, w in enumerate(workers):
            t = t0 + i * stagger_s
            evs.append(ChurnEvent(t, "remove", int(w)))
            evs.append(ChurnEvent(t + down_s, "join"))
        return ChurnSchedule(tuple(sorted(
            evs, key=lambda e: (e.t, e.action, e.worker or -1))))

    @staticmethod
    def departures(workers: Sequence[int], ts: Sequence[float]
                   ) -> "ChurnSchedule":
        """Permanent departures of ``workers`` at the matching times."""
        if len(workers) != len(ts):
            raise ValueError("need one departure time per worker")
        evs = sorted((ChurnEvent(float(t), "remove", int(w))
                      for w, t in zip(workers, ts)),
                     key=lambda e: (e.t, e.worker))
        return ChurnSchedule(tuple(evs))


@runtime_checkable
class DelayModel(Protocol):
    """Modeled round-trip seconds for one coded piece on one worker."""

    def piece_time(self, worker: int, piece: int) -> float: ...


@dataclasses.dataclass(frozen=True)
class DeterministicDelay:
    """Fixed per-worker piece duration — the test clock's workhorse.

    ``per_worker`` is either one float (uniform pool) or a sequence with
    one duration per worker.  Worker ids past the table wrap around it —
    elastic pools mint fresh ids (``add_worker``), and a joiner must get a
    deterministic duration, not an IndexError.
    """

    per_worker: float | Sequence[float] = 1.0

    def piece_time(self, worker: int, piece: int) -> float:
        if isinstance(self.per_worker, (int, float)):
            return float(self.per_worker)
        return float(self.per_worker[worker % len(self.per_worker)])


@dataclasses.dataclass(frozen=True)
class SegmentDelay:
    """Multi-layer chain round-trip (netplan segments, DESIGN.md §9).

    A segment piece is a whole chain of convs: one entry receive, one
    compute stage per layer, one exit send.  ``layer_sizes`` carries one
    :class:`PhaseSizes` per chain layer with the transmission sizes
    already placed where they occur (``n_rec`` nonzero on the first layer
    only, ``n_sen`` on the last — netplan.segment_sizes split per layer,
    or hand-built).  ``stage_times`` exposes the per-layer durations so
    the pool can record them into ``PieceTiming.stages`` — the per-layer
    telemetry the estimator consumes.  Deterministic in
    (seed, worker, piece), like every DelayModel.

    ``chunks > 1`` models streamed dispatch (DESIGN.md §11): the piece's
    entry/exit columns ship in ``chunks`` column chunks so receive,
    per-layer compute, and send pipeline instead of serializing —
    ``piece_time`` becomes :func:`~repro_torch.dist.clock.pipelined_time` over
    the chain's *sub*-stages (one receive, one compute per layer, one
    send).  ``stage_times`` still reports the raw serial per-layer lumps
    (the estimator's feed, and the scheduler's overlap evidence: the gap
    ``sum(stages) - t_compute`` is exactly the shipped-under-compute
    time).  ``chunks == 1`` is bitwise-identical to the serial model —
    same rng, same sampling order.
    """

    params: SystemParams
    layer_sizes: tuple  # tuple[PhaseSizes, ...]
    seed: int = 0
    chunks: int = 1

    def _substage_times(self, worker: int, piece: int) -> tuple:
        """Flat (rec?, cmp, ..., cmp, sen?) sub-stage durations, sampled in
        the exact order the serial model samples them."""
        rng = np.random.default_rng((self.seed, worker, piece))
        out = []
        for s in self.layer_sizes:
            if s.n_rec:
                out.append(("rec", float(
                    self.params.rec.scaled(s.n_rec).sample(rng))))
            out.append(("cmp", float(
                self.params.cmp.scaled(s.n_cmp).sample(rng))))
            if s.n_sen:
                out.append(("sen", float(
                    self.params.sen.scaled(s.n_sen).sample(rng))))
        return tuple(out)

    def stage_times(self, worker: int, piece: int) -> tuple:
        out, j = [], 0
        subs = self._substage_times(worker, piece)
        for s in self.layer_sizes:
            t = 0.0
            if s.n_rec:
                t += subs[j][1]
                j += 1
            t += subs[j][1]
            j += 1
            if s.n_sen:
                t += subs[j][1]
                j += 1
            out.append(float(t))
        return tuple(out)

    def piece_time(self, worker: int, piece: int) -> float:
        subs = [t for _, t in self._substage_times(worker, piece)]
        if self.chunks <= 1:
            return float(sum(subs))
        return float(pipelined_time(subs, self.chunks))


@dataclasses.dataclass(frozen=True)
class LayerSlowdown:
    """Per-(worker, stage) multipliers over a staged delay model.

    ``FaultPlan.straggler`` scales a worker's WHOLE round trip; the
    forensics scenarios (DESIGN.md §15) need the orthogonal axis — one
    *stage* of the chain slowing on one worker (a hot conv kernel, a
    saturated link) while its other stages stay healthy.  ``factors``
    maps worker -> {stage index -> multiplier}; unlisted coordinates keep
    their base duration.  Wraps any delay model exposing ``stage_times``
    (:class:`SegmentDelay`, :class:`ShiftExpDelay`); the wrapped piece
    time is the serial stage sum, so the slowdown is visible in BOTH
    ``PieceTiming.stages`` and the round trip — what lets the explainer
    name the (worker, phase, layer) culprit exactly.
    """

    inner: DelayModel
    factors: Mapping[int, Mapping[int, float]] = dataclasses.field(
        default_factory=dict)

    def stage_times(self, worker: int, piece: int) -> tuple:
        base = self.inner.stage_times(worker, piece)
        f = self.factors.get(worker, {})
        return tuple(t * float(f.get(j, 1.0)) for j, t in enumerate(base))

    def piece_time(self, worker: int, piece: int) -> float:
        return float(sum(self.stage_times(worker, piece)))


def per_layer_sizes(seg_sizes: Sequence[PhaseSizes]) -> tuple:
    """Normalize a list of per-layer sizes for SegmentDelay: transmission
    charged once per chain — entry receive on the first layer, exit send
    on the last (interior stages are pure compute)."""
    out = []
    last = len(seg_sizes) - 1
    for j, s in enumerate(seg_sizes):
        out.append(dataclasses.replace(
            s, n_rec=s.n_rec if j == 0 else 0.0,
            n_sen=s.n_sen if j == last else 0.0,
            n_enc=0.0, n_dec=0.0))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShiftExpDelay:
    """Paper §III round-trip: rec + cmp + sen, each shift-exponential.

    Sampling is keyed on ``(seed, worker, piece)`` so a duration is a pure
    function of its coordinates — the same piece re-dispatched to the same
    worker re-samples identically, and thread interleaving cannot perturb
    a run.  (Approximation vs ``hetero.simulate_hetero``: the input
    transmission is charged per piece, not once per worker.)

    ``chunks > 1`` pipelines the three phases as streamed column chunks
    (see :class:`SegmentDelay`): ``piece_time`` becomes
    ``pipelined_time((rec, cmp, sen), chunks)`` while ``stage_times``
    keeps reporting the raw serial phases so the overlap stays measurable.
    """

    params: SystemParams
    sizes: PhaseSizes
    seed: int = 0
    chunks: int = 1

    def stage_times(self, worker: int, piece: int) -> tuple:
        rng = np.random.default_rng((self.seed, worker, piece))
        rec = float(self.params.rec.scaled(self.sizes.n_rec).sample(rng))
        cmp = float(self.params.cmp.scaled(self.sizes.n_cmp).sample(rng))
        sen = float(self.params.sen.scaled(self.sizes.n_sen).sample(rng))
        return (rec, cmp, sen)

    def piece_time(self, worker: int, piece: int) -> float:
        stages = self.stage_times(worker, piece)
        if self.chunks <= 1:
            return float(sum(stages))
        return float(pipelined_time(stages, self.chunks))
