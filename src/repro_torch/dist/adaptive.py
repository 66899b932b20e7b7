"""Adaptive re-planning from live executor telemetry (DESIGN.md §8).

The port of the reference's ``src/repro/dist/adaptive.py``: the same
planner and loop, with ``AdaptiveExecutor.run`` returning a ``torch.Tensor``.

Closes the loop the paper leaves open ("time-varying and possibly unknown"
capacities, §I): every :class:`~repro_torch.dist.pool.WorkerPool` run already
records per-piece timings; this module fits them online
(:mod:`repro_torch.core.estimate`) and re-solves the split k° and the
heterogeneous piece allocation *between requests*, so the plan follows the
fleet as stragglers drift instead of serving a stale hand-fitted
:class:`~repro_torch.core.latency.SystemParams` forever.

Telemetry -> fit -> re-plan:

1. **observe** — :meth:`AdaptivePlanner.observe_report` normalizes each
   piece's round-trip by its *prior mean* duration (shift + excess at the
   run's phase sizes), feeding dimensionless per-unit samples into
   per-worker EWMA-windowed profiles;
2. **fit** — the pooled fleet fit yields per-unit (theta-hat, 1/mu-hat);
   dividing by the prior's own per-unit decomposition gives two
   calibration scales (shift and mean-excess), which rescale the prior's
   worker phases (:func:`~repro_torch.core.estimate.calibrated_params`) — a
   stationary fleet calibrates to exactly 1.0 and recovers the prior;
3. **re-plan** — k° is re-solved with the remainder-aware planner on the
   calibrated parameters, and the per-worker piece allocation follows the
   per-worker profile speeds (`hetero.allocate_pieces`), starving
   drifting stragglers of work before the k-th-arrival cutoff ever has to
   race them.

:class:`AdaptiveExecutor` packages the loop behind the normal
``CodedExecutor`` interface so `Engine(adaptive=True)` re-plans every
coded GEMM: `models.model._matmul` asks :meth:`AdaptiveExecutor.plan_matmul`
for the (possibly re-solved) scheme and assignment, and every completed
run is observed automatically.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

import torch

from ..core.estimate import (
    ProfileBank,
    WorkerProfile,
    calibrated_params,
    round_trip_shift_excess,
)
from ..core.hetero import allocate_pieces
from ..core.latency import PhaseSizes, SystemParams, phase_sizes
from ..core.planner import k_circ_remainder_aware
from ..core.schemes import CodingScheme
from ..core.splitting import ConvSpec
from .executor import CodedExecutor
from .pool import RunReport

__all__ = ["AdaptivePlan", "AdaptivePlanner", "AdaptiveExecutor", "gemm_spec"]


def gemm_spec(n_tokens: int, d_in: int, d_out: int) -> ConvSpec:
    """A GEMM as the K=S=1 degenerate conv (DESIGN.md §4): tokens play the
    output width, so the planner's k° machinery applies unchanged."""
    return ConvSpec(c_in=d_in, c_out=d_out, h_in=1, w_in=n_tokens, kernel=1)


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    """One re-planning decision: the split and who runs how many pieces."""

    k: int
    n_pieces: int
    assignment: list[int] | None   # per-worker counts; None = round-robin
    params: SystemParams           # calibrated params the plan was solved on
    from_telemetry: bool           # False while still running on the prior


class AdaptivePlanner:
    """Online (mu, theta) estimation + (k°, allocation) re-planning.

    ``prior`` anchors the phase decomposition (telemetry only sees whole
    round-trips) and serves verbatim until ``min_samples`` observations
    per worker make the profiles trustworthy.  Thread-safe: the serving
    engine observes and plans from its request loop while benchmarks may
    inspect profiles concurrently.
    """

    def __init__(self, prior: SystemParams | None = None, *,
                 window: int = 64, alpha: float = 0.25, min_samples: int = 8):
        self.prior = prior if prior is not None else SystemParams()
        self.bank = ProfileBank(window=window, alpha=alpha,
                                min_samples=min_samples)
        # per-LAYER profiles, pooled across workers (DESIGN.md §15): a
        # localized per-layer slowdown moves one of these means off 1.0,
        # which is what lets replan_segments re-cut segment boundaries
        # instead of only recalibrating the fleet-uniform k°
        self._layer_obs: dict[int, WorkerProfile] = {}
        self._alpha = alpha
        self._shift_frac: float | None = None  # EWMA prior shift fraction
        self._lock = threading.Lock()

    # -- telemetry ---------------------------------------------------------
    def observe_report(self, report: RunReport,
                       sizes: PhaseSizes | Sequence[PhaseSizes], *,
                       at: float | None = None,
                       layer_ids: Sequence[int] | None = None) -> None:
        """Ingest one run's per-piece timings, normalized by the prior mean
        round-trip at the run's phase sizes (so profiles learned at one
        split price plans at another).

        ``sizes`` may be a *sequence* of per-layer PhaseSizes for
        multi-layer segment pieces (netplan, DESIGN.md §9): when a
        timing carries per-layer ``stages`` matching it, each stage feeds
        the profile as its own normalized sample — a depth-d segment
        yields d estimator observations per piece instead of one.  Those
        per-stage samples also feed per-LAYER profiles under the global
        layer ids ``layer_ids`` (default: position in ``sizes``), the
        evidence :meth:`replan_segments` re-cuts boundaries from.  ``at``
        stamps the samples on the caller's timeline so a detected regime
        shift can :meth:`reset_at` the pre-shift history away."""
        per_layer = None
        if not isinstance(sizes, PhaseSizes):
            per_layer = [round_trip_shift_excess(s, self.prior)
                         for s in sizes]
            shift = sum(s for s, _ in per_layer)
            excess = sum(e for _, e in per_layer)
            if layer_ids is None:
                layer_ids = range(len(per_layer))
            layer_ids = [int(l) for l in layer_ids]
            if len(layer_ids) != len(per_layer):
                raise ValueError(f"{len(layer_ids)} layer_ids for "
                                 f"{len(per_layer)} layers")
        else:
            shift, excess = round_trip_shift_excess(sizes, self.prior)
        unit = shift + excess
        if unit <= 0.0:
            raise ValueError(f"degenerate prior round-trip for {sizes}")
        with self._lock:
            for t in report.timings:
                if (per_layer is not None and t.stages
                        and len(t.stages) == len(per_layer)):
                    for lid, dur, (s, e) in zip(layer_ids, t.stages,
                                                per_layer):
                        if s + e > 0.0:
                            self.bank.observe(t.worker, dur, units=s + e,
                                              t=at)
                            self._layer_profile(lid).observe(
                                dur, units=s + e, t=at)
                else:
                    self.bank.observe(t.worker, t.t_compute, units=unit,
                                      t=at)
            rho = shift / unit
            self._shift_frac = (rho if self._shift_frac is None else
                                (1 - self._alpha) * self._shift_frac
                                + self._alpha * rho)

    def _layer_profile(self, layer: int) -> WorkerProfile:
        if layer not in self._layer_obs:
            self._layer_obs[layer] = WorkerProfile(
                self.bank.window, self.bank.alpha,
                min_samples=self.bank.min_samples)
        return self._layer_obs[layer]

    def reset_at(self, t: float) -> None:
        """Forward a detected regime shift: every per-worker and per-layer
        profile drops its pre-``t`` samples and refits on the post-shift
        window only — the regime-bleed fix (core/estimate.py), exposed
        where the forensics loop (telemetry/explain.py) can pull it."""
        with self._lock:
            self.bank.reset_at(t)
            for p in self._layer_obs.values():
                p.reset_at(t)

    def layer_scales(self, layer_ids: Sequence[int]) -> list[float]:
        """Observed per-unit slowdown of each layer vs the prior (1.0 =
        on-baseline or not enough evidence) — ``LayerInfo.cmp_scale``
        currency.  Per-layer samples are normalized by the prior's mean,
        so a healthy layer's profile mean sits at 1.0 and an Xx-slowed
        layer's at ~X."""
        with self._lock:
            out = []
            for lid in layer_ids:
                p = self._layer_obs.get(int(lid))
                out.append(float(p.mean())
                           if p is not None and p.ready else 1.0)
        return out

    @property
    def ready(self) -> bool:
        return self.bank.ready and self._shift_frac is not None

    # -- fit ---------------------------------------------------------------
    def params_hat(self) -> SystemParams:
        """Prior rescaled by the fleet fit; the prior itself until ready."""
        with self._lock:
            if not self.ready:
                return self.prior
            fit = self.bank.fleet_fit()
            rho = self._shift_frac
        theta_scale = fit.theta / rho if rho > 0.0 else 1.0
        excess_scale = (1.0 / fit.mu) / (1.0 - rho) if rho < 1.0 else 1.0
        return calibrated_params(self.prior, theta_scale, excess_scale)

    def speeds(self, n_workers: int) -> list[float]:
        with self._lock:
            return self.bank.speeds(n_workers)

    # -- re-plan -----------------------------------------------------------
    def plan(self, spec: ConvSpec, n_pieces: int, n_workers: int,
             *, fixed_k: int | None = None,
             workers: Sequence[int] | None = None) -> AdaptivePlan:
        """Re-solve k° (remainder-aware) and the piece allocation from the
        current profiles.  ``fixed_k`` pins the split (schemes whose k is
        structural — replication, uncoded) so only the allocation adapts.
        ``workers`` names the dispatchable candidates explicitly (elastic
        fleets): the allocation is solved over THEIR speeds, positionally —
        without it a churned fleet would get counts sized to the wrong
        worker set."""
        params = self.params_hat()
        if fixed_k is not None:
            k = fixed_k
        else:
            k = k_circ_remainder_aware(spec, n_pieces, params)
        assignment = None
        if self.ready:
            if workers is not None:
                ws = [int(w) for w in workers]
                if ws:
                    sp = self.speeds(max(ws) + 1)
                    assignment = allocate_pieces([sp[w] for w in ws],
                                                 n_pieces)
            elif n_workers > 0:
                assignment = allocate_pieces(self.speeds(n_workers),
                                             n_pieces)
        return AdaptivePlan(k=k, n_pieces=n_pieces, assignment=assignment,
                            params=params, from_telemetry=self.ready)

    def replan_segments(self, layers: Sequence, n: int, *,
                        scheme: str = "mds", **compile_kw):
        """Re-run the netplan cut DP from live telemetry (DESIGN.md §15).

        Uses the finest-grained evidence available.  With per-layer
        profiles (stage telemetry from segment pieces), each layer's
        ``cmp_scale`` is set to its observed absolute slowdown and the
        stack is re-compiled on the PRIOR params — the drift is priced
        exactly where it was measured, so a slowed layer can MOVE a
        segment boundary (isolate itself into a shallow segment with its
        own k°).  Re-compiling on ``params_hat`` instead would charge the
        drift twice: the round-trip calibration smears the localized
        slowdown fleet-wide (inflating master/encode/decode costs that
        never drifted) AND the scales price it per-layer.  With no
        per-layer evidence the plan falls back to the static compile on
        calibrated ``params_hat`` — k°-only adaptation, the best a
        round-trip-only view can do.  Returns the fresh
        :class:`~repro_torch.core.netplan.NetPlan`."""
        from ..core.netplan import compile_plan

        with self._lock:
            fine = any(p.ready for p in self._layer_obs.values())
        if not fine:
            return compile_plan(tuple(layers), n, self.params_hat(),
                                scheme, **compile_kw)
        scales = self.layer_scales(range(len(layers)))
        scaled = tuple(dataclasses.replace(li, cmp_scale=s)
                       for li, s in zip(layers, scales))
        return compile_plan(scaled, n, self.prior, scheme, **compile_kw)


class AdaptiveExecutor(CodedExecutor):
    """A ``CodedExecutor`` that re-plans before each run and learns after.

    Drop-in for every ``executor=`` seam (`coded_conv2d`, `coded_matmul`,
    `Engine`): runs behave identically until enough telemetry accumulates,
    then piece assignments follow the live per-worker speeds.  The serving
    path additionally re-solves k per coded GEMM via :meth:`plan_matmul`
    (`models.model._matmul` duck-types on it).
    """

    def __init__(self, n_workers: int | None = None, *,
                 planner: AdaptivePlanner | None = None,
                 prior: SystemParams | None = None,
                 probe_every: int = 8, **kw):
        super().__init__(n_workers, **kw)
        self.planner = planner if planner is not None else AdaptivePlanner(prior)
        # every probe_every-th run gathers ALL pieces before decoding:
        # k-of-n cancellation means a straggler never completes, so pure
        # completion telemetry can never see it slow down (survivorship
        # bias) — probes pay one run's early-exit saving to observe every
        # worker's true service time.  0 disables probing.
        self.probe_every = int(probe_every)
        self.last_was_probe = False
        self._runs = 0
        self._pending_sizes: PhaseSizes | None = None
        self._pending_layer_ids: Sequence[int] | None = None

    def arm_observation(self, sizes: PhaseSizes | Sequence[PhaseSizes], *,
                        layer_ids: Sequence[int] | None = None) -> None:
        """Declare the next run's work content so its report feeds the
        planner — callers that bypass :meth:`plan_matmul` (the conv path,
        benchmarks) arm this before invoking ``coded_conv2d`` /
        ``run_segment``.  A sequence of per-layer sizes declares a
        multi-layer segment piece (per-stage telemetry); ``layer_ids``
        names the GLOBAL layer each stage belongs to, so a mid-network
        segment trains the right per-layer profiles."""
        self._pending_sizes = sizes
        self._pending_layer_ids = layer_ids

    def ensure_armed(self, sizes) -> None:
        """As :meth:`arm_observation`, but defers to anything the caller
        armed explicitly — the seam ``run_segment`` uses to auto-feed the
        planner with its per-layer sizes."""
        if self._pending_sizes is None:
            self._pending_sizes = sizes

    def plan_matmul(self, scheme: CodingScheme, scheme_name: str,
                    n_tokens: int, d_in: int, d_out: int
                    ) -> tuple[int | None, int | None, Sequence[int] | None]:
        """Re-plan one coded GEMM: returns (n or None to keep the scheme's,
        k or None likewise, per-worker assignment or None for round-robin)
        and arms the post-run observation with this GEMM's phase sizes.

        Membership drives n (elastic fleets follow the live worker count);
        k is profile-driven k° for MDS, structural ``redundancy_policy``
        for selection schemes when n moved, and untouched for rateless
        schemes (LT keeps k — more members just mean more coded rows)."""
        cand = self.pool.dispatch_preview(self._base_workers)
        n_new = self._elastic_n(scheme)
        n_eff = n_new if n_new is not None else scheme.n
        spec = gemm_spec(n_tokens, d_in, d_out)
        adapt_k = scheme_name in ("mds", "coded")  # k° is an MDS notion
        if adapt_k:
            fixed_k = None
        elif n_new is None or getattr(scheme, "rateless", False):
            fixed_k = scheme.k
        else:
            fixed_k = type(scheme).redundancy_policy(n_eff)
        plan = self.planner.plan(spec, n_eff, len(cand), fixed_k=fixed_k,
                                 workers=cand)
        if adapt_k:
            k = plan.k
        else:
            k = fixed_k if fixed_k != scheme.k else None
        self.arm_observation(phase_sizes(spec, n_eff,
                                         plan.k if adapt_k else scheme.k))
        return n_new, k, plan.assignment

    def run(self, scheme: CodingScheme,
            piece_fns: Sequence[Callable[[], Any]], *,
            assignment: Sequence[int] | None = None,
            speeds: Sequence[float] | None = None,
            sizes: PhaseSizes | Sequence[PhaseSizes] | None = None,
            **kw) -> torch.Tensor:
        """As ``CodedExecutor.run``; additionally plans the assignment from
        live profiles when the caller gave none, and feeds the run's
        timings back into the planner (``sizes`` — or the pending sizes a
        ``plan_matmul`` call armed — tell it the work content)."""
        if assignment is None and speeds is None and self.planner.ready:
            # allocate over the workers this run can actually dispatch to —
            # pool.n_workers counts departed members too under churn
            cand = self.pool.dispatch_preview(self._base_workers)
            if cand:
                sp = self.planner.speeds(max(cand) + 1)
                assignment = allocate_pieces([sp[w] for w in cand],
                                             scheme.n)
        self._runs += 1
        probe = self.probe_every > 0 and self._runs % self.probe_every == 0
        if probe and assignment is not None and 0 in assignment:
            # a probe must exercise every worker, including ones the
            # current plan starves — otherwise a recovered straggler could
            # never earn its pieces back; spread the probe round-robin
            assignment = None
        self.last_was_probe = probe
        out = super().run(scheme, piece_fns, assignment=assignment,
                          speeds=speeds, gather_all=probe, **kw)
        observe = sizes if sizes is not None else self._pending_sizes
        lids = None if sizes is not None else self._pending_layer_ids
        self._pending_sizes = self._pending_layer_ids = None
        if observe is not None and self.last_report is not None:
            self.planner.observe_report(self.last_report, observe,
                                        layer_ids=lids)
        return out
