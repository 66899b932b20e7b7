"""Online shift-exponential (mu, theta) estimation (DESIGN.md §8).

A copy of the reference's ``src/repro/core/estimate.py`` (pure numpy, the
same numbers), kept here because the port imports nothing of ``repro``.


The paper's premise is that device capacities are "time-varying and
possibly unknown", yet the planner consumes a static, hand-fitted
:class:`~repro_torch.core.latency.SystemParams`.  This module closes the loop
from the telemetry side:

* :func:`fit_shift_exp` — MLE for Definition 1's shift-exponential from
  per-unit duration samples: the shift estimate comes from the sample
  minimum, the straggle rate from the mean excess over it (with the
  standard small-sample bias correction — the raw minimum overshoots the
  true shift by 1/(m·mu) in expectation);
* :class:`WorkerProfile` — a sliding-window fit blended through an EWMA,
  so a drifting worker's profile tracks a capacity step within roughly one
  window instead of averaging over its whole history;
* :class:`ProfileBank` — per-worker profiles keyed by worker id, plus the
  pooled fleet fit the planner calibrates k° against.

Per-unit normalization: a phase duration T at scaling N (FLOPs or bytes,
eqs. 8-12) satisfies T/N = theta + Exp(mu) exactly under Definition 1, so
dividing by the known work content makes samples from *different split
sizes* commensurable — a profile learned at k=4 prices a plan at k=7.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

import numpy as np

from .latency import PhaseSizes, ShiftExp, SystemParams

__all__ = [
    "fit_shift_exp",
    "WorkerProfile",
    "ProfileBank",
    "round_trip_shift_excess",
    "calibrated_params",
]


def fit_shift_exp(samples: Iterable[float], units: float | np.ndarray = 1.0,
                  bias_correct: bool = True) -> ShiftExp:
    """MLE (mu, theta) of a shift-exponential from duration samples.

    ``samples`` are durations observed at work content ``units`` (scalar
    or one entry per sample); fitting happens on the per-unit values
    u = T/N ~ theta + Exp(mu).  The MLE is theta_hat = u_(1),
    mu_hat = 1/(mean(u) - u_(1)); with ``bias_correct`` the estimators are
    debiased (E[u_(1)] = theta + 1/(m mu)):

        excess_hat = m/(m-1) * (mean(u) - u_(1))
        theta_hat  = u_(1) - excess_hat/m

    Returns a per-unit :class:`ShiftExp` (scale with ``.scaled(N)``).
    """
    u = np.asarray(list(samples), dtype=np.float64)
    if u.ndim != 1 or u.size < 2:
        raise ValueError(f"need >= 2 samples to fit, got shape {u.shape}")
    if not np.all(np.isfinite(u)):
        raise ValueError("samples must be finite")
    u = u / np.asarray(units, dtype=np.float64)
    m = u.size
    u_min = float(u.min())
    excess = float(u.mean() - u_min)
    if bias_correct:
        excess *= m / (m - 1)
        theta = u_min - excess / m
    else:
        theta = u_min
    # identical samples (deterministic delays) would give mu = inf; keep it
    # finite so downstream SystemParams arithmetic stays well-defined
    excess = max(excess, 1e-15 * max(abs(u_min), 1.0))
    return ShiftExp(mu=1.0 / excess, theta=max(theta, 0.0))


@dataclasses.dataclass
class WorkerProfile:
    """EWMA-windowed per-unit (mu, theta) tracker for one worker.

    Every observation lands in a sliding window; the window is refit and
    the fit blended into the running estimate with weight ``alpha``.  The
    window bounds how much history a drifting worker drags along; the EWMA
    smooths fit-to-fit jitter.  Until ``min_samples`` observations the
    profile reports not-ready and ``speed()`` falls back to the prior.
    """

    window: int = 64
    alpha: float = 0.25
    min_samples: int = 8
    _samples: deque = dataclasses.field(default=None, repr=False)
    n_observed: int = 0
    mu: float | None = None
    theta: float | None = None

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        # (timestamp, per-unit value) pairs: timestamps let a detected
        # regime shift discard the pre-shift prefix exactly (reset_at)
        # instead of waiting a whole window for the EWMA to forget it
        self._samples = deque(maxlen=self.window)

    @property
    def ready(self) -> bool:
        return self.n_observed >= max(self.min_samples, 2)

    def observe(self, duration: float, units: float = 1.0,
                t: float | None = None) -> None:
        """Feed one duration observed at work content ``units``.

        ``t`` stamps the sample on the caller's timeline (virtual seconds
        from the serving loop, arrival index otherwise); it defaults to
        the observation count so ``reset_at`` is always meaningful.
        """
        if not np.isfinite(duration) or duration < 0.0 or units <= 0.0:
            raise ValueError(f"bad observation ({duration}, {units})")
        if t is None:
            t = float(self.n_observed)
        self._samples.append((float(t), duration / units))
        self.n_observed += 1
        if len(self._samples) < 2:
            return
        fit = fit_shift_exp(self.window_samples())
        if self.mu is None:
            self.mu, self.theta = fit.mu, fit.theta
        else:
            # EWMA on (theta, 1/mu): the mean-excess blends linearly,
            # blending rates directly would bias toward fast windows
            self.theta = (1 - self.alpha) * self.theta + self.alpha * fit.theta
            excess = ((1 - self.alpha) / self.mu + self.alpha / fit.mu)
            self.mu = 1.0 / excess

    def reset_at(self, t: float) -> None:
        """Drop every sample stamped before ``t`` and refit on what's left.

        This is the regime-bleed fix: after a detected shift
        the EWMA would otherwise keep blending pre-shift samples still in
        the window, biasing the post-shift (mu, theta) for up to a full
        window.  The refit is DIRECT (no EWMA history): the post-shift
        regime's first fit should owe nothing to the old one.  With fewer
        than 2 surviving samples the profile returns to cold start.
        """
        kept = [(ts, u) for ts, u in self._samples if ts >= t]
        self._samples = deque(kept, maxlen=self.window)
        self.n_observed = len(kept)
        if len(kept) >= 2:
            fit = fit_shift_exp([u for _, u in kept])
            self.mu, self.theta = fit.mu, fit.theta
        else:
            self.mu = self.theta = None

    def fit(self) -> ShiftExp:
        if self.mu is None:
            raise ValueError("profile has no observations yet")
        return ShiftExp(mu=self.mu, theta=self.theta)

    def mean(self) -> float:
        """Expected per-unit duration theta + 1/mu of the current fit."""
        f = self.fit()
        return f.theta + 1.0 / f.mu

    def speed(self) -> float:
        """Per-unit service rate — ``hetero.allocate_pieces`` currency."""
        return 1.0 / self.mean()

    def window_samples(self) -> list[float]:
        return [u for _, u in self._samples]


class ProfileBank:
    """Per-worker :class:`WorkerProfile` registry + the pooled fleet fit."""

    def __init__(self, window: int = 64, alpha: float = 0.25,
                 min_samples: int = 8):
        self.window, self.alpha, self.min_samples = window, alpha, min_samples
        self.profiles: dict[int, WorkerProfile] = {}

    def profile(self, worker: int) -> WorkerProfile:
        if worker not in self.profiles:
            self.profiles[worker] = WorkerProfile(
                self.window, self.alpha, min_samples=self.min_samples)
        return self.profiles[worker]

    def observe(self, worker: int, duration: float, units: float = 1.0,
                t: float | None = None) -> None:
        self.profile(worker).observe(duration, units, t=t)

    def reset_at(self, t: float) -> None:
        """Forward a detected regime shift to every profile (see
        :meth:`WorkerProfile.reset_at`)."""
        for p in self.profiles.values():
            p.reset_at(t)

    def speeds(self, n_workers: int, default: float | None = None) -> list[float]:
        """Relative per-unit service rates for ``allocate_pieces``.

        Workers without a ready profile get ``default`` — the *median* ready
        speed when None, so an unobserved worker is treated as typical
        rather than fast or dead.
        """
        ready = [p.speed() for p in self.profiles.values() if p.ready]
        if default is None:
            default = float(np.median(ready)) if ready else 1.0
        out = []
        for w in range(n_workers):
            p = self.profiles.get(w)
            out.append(p.speed() if p is not None and p.ready else default)
        return out

    def fleet_fit(self) -> ShiftExp:
        """Shift-exp fit pooled over every worker's current window — what
        the homogeneous k° objective calibrates against."""
        pooled: list[float] = []
        for p in self.profiles.values():
            pooled.extend(p.window_samples())
        return fit_shift_exp(pooled)

    @property
    def ready(self) -> bool:
        return any(p.ready for p in self.profiles.values())


# ---------------------------------------------------------------------------
# bridging fits back into SystemParams for the planner
# ---------------------------------------------------------------------------

def round_trip_shift_excess(sizes: PhaseSizes, params: SystemParams
                            ) -> tuple[float, float]:
    """(deterministic shift, mean exponential excess) of one worker
    round-trip rec+cmp+sen at the given phase sizes (eq. 6)."""
    shift = (sizes.n_rec * params.theta_rec + sizes.n_cmp * params.theta_cmp
             + sizes.n_sen * params.theta_sen)
    excess = (sizes.n_rec / params.mu_rec + sizes.n_cmp / params.mu_cmp
              + sizes.n_sen / params.mu_sen)
    return shift, excess


def calibrated_params(prior: SystemParams, theta_scale: float,
                      excess_scale: float) -> SystemParams:
    """Rescale the prior's *worker* phases by observed calibration factors.

    Telemetry sees the combined round-trip, not individual phases, so the
    prior's decomposition across rec/cmp/sen is kept and only its overall
    scale moves: every worker theta is multiplied by ``theta_scale`` and
    every worker mean-excess by ``excess_scale`` (mu divides).  Master
    encode/decode parameters are left untouched — the master is local and
    separately observable.  Stationary telemetry gives scales of 1.0 and
    returns the prior exactly, which is what makes the adaptive planner
    converge to the static plan (tests/test_torch_adaptive.py).
    """
    if theta_scale < 0.0 or excess_scale <= 0.0:
        raise ValueError(f"bad calibration ({theta_scale}, {excess_scale})")
    return dataclasses.replace(
        prior,
        theta_cmp=prior.theta_cmp * theta_scale,
        theta_rec=prior.theta_rec * theta_scale,
        theta_sen=prior.theta_sen * theta_scale,
        mu_cmp=prior.mu_cmp / excess_scale,
        mu_rec=prior.mu_rec / excess_scale,
        mu_sen=prior.mu_sen / excess_scale,
    )
