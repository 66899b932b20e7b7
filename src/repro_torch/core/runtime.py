"""Master/worker simulation of CoCoI (paper §V scenarios) — vectorized and
scheme-agnostic.

A copy of the reference's ``src/repro/core/runtime.py`` (pure numpy, the
same draws from the same seeds), kept here because the port imports
nothing of ``repro``.

One generic simulation loop, :func:`_run_scheme`, does it for any
registered scheme (core/schemes.py):

1. resolves the scheme's :class:`SimPlan` (worker count, per-worker phase
   sizes, master encode/decode/remainder sizes);
2. samples every phase as a ``(trials, n)`` batch from the shift-exponential
   model, applying scenario-1 channel contention (``lambda_tr``) and the
   scenario-3 high-probability straggler ONCE;
3. draws per-trial failure sets (scenario-2) ONCE;
4. hands the batch to the scheme's vectorized completion rule
   (``sim_exec``), which may invoke the shared detection/retry helpers;
5. folds in the master's encode/decode terms and the footnote-2 remainder.

``simulate_layer`` (one trial, float) and ``simulate_network`` (a whole
(trials,) batch per layer, summed) are thin wrappers over it.

Failure semantics: a failed worker signals the
master at the moment it would have completed (detection time); the affected
subtask is then re-executed on a fresh device, or simply ignored if enough
redundancy remains.  This mirrors §V's "if any worker fails, the subtask
will be re-assigned ... for re-execution".
"""
from __future__ import annotations

from typing import Literal

import numpy as np

from .latency import SystemParams, phase_sizes
from .schemes import (
    SimBatch,
    SimPlan,
    SimScenario,
    get_scheme,
    lt_overhead_samples,
)
from .splitting import ConvSpec

Method = Literal["coded", "mds", "uncoded", "replication", "lt"]

__all__ = [
    "SimScenario",
    "simulate_layer",
    "simulate_layer_batch",
    "simulate_network",
    "lt_overhead_samples",
]


# ---------------------------------------------------------------------------
# vectorized shift-exponential sampling
# ---------------------------------------------------------------------------

def _se_batch(rng, mu: float, theta: float, N: np.ndarray, trials: int,
              scale_mult: np.ndarray | None = None) -> np.ndarray:
    """(trials, n) draws of N_i*theta + Exp(N_i/mu); ``scale_mult`` scales
    the exponential part per worker (the scenario-3 straggler)."""
    N = np.asarray(N, dtype=float)
    scale = N / mu
    if scale_mult is not None:
        scale = scale * scale_mult
    return (N * theta)[None, :] + rng.exponential(1.0, (trials, N.size)) * scale[None, :]


def _sample_worker_batch(plan: SimPlan, spec: ConvSpec, params: SystemParams,
                         scenario: SimScenario, rng, trials: int,
                         clean: bool = False) -> np.ndarray:
    """(trials, n) worker round-trips rec+cmp+sen with scenario effects.

    ``clean=True`` drops the scenario effects (used for retry rounds, which
    run on fresh devices after the straggling event has passed, as a
    ``SimScenario()`` would).
    """
    n = plan.n_rec.size
    slow = None
    if not clean and scenario.straggler_slow > 1.0:
        # high-probability straggler: worker 0's mu_cmp /= slow, i.e. its
        # exponential scale is straggler_slow x the others'
        slow = np.ones(n)
        slow[0] = scenario.straggler_slow
    rec = _se_batch(rng, params.mu_rec, params.theta_rec, plan.n_rec, trials)
    cmp_ = _se_batch(rng, params.mu_cmp, params.theta_cmp, plan.n_cmp, trials,
                     scale_mult=slow)
    sen = _se_batch(rng, params.mu_sen, params.theta_sen, plan.n_sen, trials)
    if not clean and scenario.lambda_tr > 0.0:
        # §V scenario-1: the injected wireless delay models CHANNEL
        # contention — its scale is lambda_tr times the typical per-worker
        # message time of this layer, NOT the (method-dependent) partition
        # size, so every method faces the same delay distribution.
        n_full = max(plan.n, plan.k)
        s_ref = phase_sizes(spec, n_full, min(n_full, spec.w_out))
        rec = rec + rng.exponential(
            scenario.lambda_tr * params.rec.scaled(s_ref.n_rec).mean(),
            size=(trials, n))
        sen = sen + rng.exponential(
            scenario.lambda_tr * params.sen.scaled(s_ref.n_sen).mean(),
            size=(trials, n))
    return rec + cmp_ + sen


def _fail_sets(n: int, n_fail: int, rng, trials: int) -> np.ndarray:
    """(trials, n) masks with exactly n_fail True per row, uniform subsets."""
    mask = np.zeros((trials, n), dtype=bool)
    if n_fail:
        idx = rng.random((trials, n)).argsort(axis=1)[:, :n_fail]
        np.put_along_axis(mask, idx, True, axis=1)
    return mask


# ---------------------------------------------------------------------------
# the one generic simulation loop
# ---------------------------------------------------------------------------

def _run_scheme(
    method: str,
    spec: ConvSpec,
    n: int,
    params: SystemParams,
    k: int | None,
    scenario: SimScenario,
    rng: np.random.Generator,
    trials: int,
) -> np.ndarray:
    """(trials,) end-to-end latencies of one type-1 layer under ``method``."""
    scheme = get_scheme(method)
    plan = scheme.sim_plan(spec, n, k, params, scenario)

    fail = _fail_sets(plan.n, min(scenario.n_fail, plan.n), rng, trials)
    if plan.rateless:
        # rateless schemes stream symbols inside sim_exec; no single
        # round-trip matrix exists
        tw = np.zeros((trials, plan.n))
    else:
        tw = _sample_worker_batch(plan, spec, params, scenario, rng, trials)

    def retry_uniform(num: int, m: int) -> np.ndarray:
        uni = SimPlan(k=plan.k, n=m, n_rec=np.full(m, plan.n_rec[0]),
                      n_cmp=np.full(m, plan.n_cmp[0]),
                      n_sen=np.full(m, plan.n_sen[0]))
        return _sample_worker_batch(uni, spec, params, scenario, rng, num,
                                    clean=True)

    def retry_per_worker(num: int) -> np.ndarray:
        return _sample_worker_batch(plan, spec, params, scenario, rng, num,
                                    clean=True)

    batch = SimBatch(tw=tw, fail=fail, rng=rng, spec=spec, params=params,
                     scenario=scenario, retry_uniform=retry_uniform,
                     retry_per_worker=retry_per_worker)
    t_exec = np.asarray(scheme.sim_exec(plan, batch), dtype=float)

    # footnote 2: the master computes the mod(W_O, k) remainder concurrently
    if plan.rem_flops:
        t_exec = np.maximum(
            t_exec, params.cmp.scaled(plan.rem_flops).sample(rng, (trials,)))
    total = t_exec
    if plan.n_enc:
        total = total + params.master.scaled(plan.n_enc).sample(rng, (trials,))
    if plan.n_dec:
        total = total + params.master.scaled(plan.n_dec).sample(rng, (trials,))
    return total


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def simulate_layer(
    spec: ConvSpec,
    n: int,
    params: SystemParams,
    method: Method = "coded",
    k: int | None = None,
    scenario: SimScenario = SimScenario(),
    rng: np.random.Generator | None = None,
) -> float:
    """One trial: end-to-end latency of a single type-1 layer execution."""
    rng = rng or np.random.default_rng(0)
    return float(_run_scheme(method, spec, n, params, k, scenario, rng, 1)[0])


def simulate_layer_batch(
    spec: ConvSpec,
    n: int,
    params: SystemParams,
    method: Method = "coded",
    k: int | None = None,
    scenario: SimScenario = SimScenario(),
    rng: np.random.Generator | None = None,
    trials: int = 100,
) -> np.ndarray:
    """(trials,) i.i.d. latencies of one layer — the vectorized form."""
    rng = rng or np.random.default_rng(0)
    return _run_scheme(method, spec, n, params, k, scenario, rng, trials)


def simulate_network(
    specs: list[ConvSpec],
    n: int,
    params: SystemParams,
    method: Method = "coded",
    ks: list[int] | None = None,
    scenario: SimScenario = SimScenario(),
    trials: int = 20,
    seed: int = 0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """End-to-end CNN inference latency: sum of per-layer trials.

    Returns (trials,) array of total latencies over the type-1 layers,
    sampled as one batch per layer (no Python trial loop).  Type-2
    (master-local) work is negligible per the paper (App. A: conv is >99%
    of latency) and omitted here.
    """
    rng = rng or np.random.default_rng(seed)
    out = np.zeros(trials)
    for i, spec in enumerate(specs):
        k = ks[i] if ks is not None else None
        out += _run_scheme(method, spec, n, params, k, scenario, rng, trials)
    return out
