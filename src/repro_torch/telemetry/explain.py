"""SLO breach explanation: who, which phase, which layer, since when.

A copy of the reference's ``src/repro/telemetry/explain.py`` (pure numpy,
the same bytes from ``CulpritReport.to_json``), kept here because the port
imports nothing of ``repro``.

The ylatency recipe (SEALABQualityGroup, see SNIPPETS.md) adapted to
coded inference: the raw evidence is per-(worker, phase, layer) latency
samples extracted from each request's :class:`~repro_torch.dist.pool.RunReport`
piece timings, and the question is which *threshold combination* over
those features best explains the set of SLO-violating requests.

Pipeline:

1. **features** — :func:`features_from_report` turns one run's
   ``PieceTiming.stages`` into ``{(worker, phase, layer): seconds}``
   (``rec``/``cmp``/``sen`` for GEMM round-trips, per-layer ``cmp`` for
   segment chains, whole round-trip ``rt`` when no stages exist);
   :class:`BreachDataset` stacks one row per request next to its breach
   flag and timestamp.
2. **regimes** — :func:`detect_regimes` runs a mean-shift (CUSUM-style
   binary segmentation) statistic over each feature's series and returns
   the best split point; :func:`candidate_predicates` keeps the features
   whose post-shift mean rose and derives each one's threshold (the
   regime-mean midpoint).
3. **search** — :func:`search_culprits` searches subsets of those
   predicates for the one maximizing the F-measure of "some selected
   feature exceeded its threshold" against the breach set: exact
   branch-and-bound up to ``max_exact`` candidates (the bound exploits
   that a union can only grow TP and FP), a seeded genetic algorithm
   beyond it (large fleets), both deterministic.

Everything is a pure function of the inputs: on the virtual clock the
ranked :class:`CulpritReport` serializes to identical bytes across runs
(``to_json``), which the acceptance tests pin.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "FeatureKey",
    "features_from_report",
    "BreachDataset",
    "RegimeSplit",
    "detect_regimes",
    "Predicate",
    "candidate_predicates",
    "Culprit",
    "CulpritReport",
    "search_culprits",
    "explain_breaches",
]

GEMM_PHASES = ("rec", "cmp", "sen")


@dataclasses.dataclass(frozen=True, order=True)
class FeatureKey:
    """One latency series: a worker's phase on a layer (0 when the run has
    no layer structure)."""

    worker: int
    phase: str
    layer: int

    def label(self) -> str:
        return f"worker {self.worker}/{self.phase}/layer {self.layer}"


def features_from_report(report, *, per_layer: bool = False
                         ) -> dict[FeatureKey, float]:
    """``{(worker, phase, layer): seconds}`` of one run's piece timings.

    ``per_layer=True`` reads each timing's ``stages`` as one compute
    stage per chain layer (segment runs); otherwise exactly-3-stage
    timings are the GEMM ``(rec, cmp, sen)`` round-trip and anything else
    falls back to the whole round-trip ``rt``.  A worker serving several
    pieces contributes its slowest sample per key — the tail is what
    breaches an SLO.
    """
    out: dict[FeatureKey, float] = {}

    def put(key: FeatureKey, v: float) -> None:
        if v > out.get(key, float("-inf")):
            out[key] = float(v)

    for tm in report.timings:
        if tm.stages and per_layer:
            for j, dur in enumerate(tm.stages):
                put(FeatureKey(tm.worker, "cmp", j), dur)
        elif tm.stages and len(tm.stages) == len(GEMM_PHASES):
            for ph, dur in zip(GEMM_PHASES, tm.stages):
                put(FeatureKey(tm.worker, ph, 0), dur)
        else:
            put(FeatureKey(tm.worker, "rt", 0), tm.t_compute)
    return out


class BreachDataset:
    """Rows of per-request feature values next to the breach flags.

    ``rows[i]`` maps feature keys to request i's observed seconds (a key
    may be absent — the worker served no piece that request); ``breach``
    flags the SLO violators; ``times`` places each request on the
    (virtual) timeline, defaulting to its index.
    """

    def __init__(self, rows: Sequence[Mapping[FeatureKey, float]],
                 breach: Sequence[bool],
                 times: Sequence[float] | None = None):
        if len(rows) != len(breach):
            raise ValueError(f"{len(rows)} rows vs {len(breach)} breach flags")
        if times is not None and len(times) != len(rows):
            raise ValueError(f"{len(rows)} rows vs {len(times)} times")
        self.rows = [dict(r) for r in rows]
        self.breach = np.asarray(list(breach), bool)
        self.times = (np.asarray(list(times), np.float64) if times is not None
                      else np.arange(len(rows), dtype=np.float64))
        self.keys: list[FeatureKey] = sorted({k for r in self.rows for k in r})

    def __len__(self) -> int:
        return len(self.rows)

    def series(self, key: FeatureKey) -> np.ndarray:
        """Request-indexed values for one feature (NaN where unobserved)."""
        return np.asarray([r.get(key, np.nan) for r in self.rows], np.float64)

    def distributions(self) -> dict[FeatureKey, np.ndarray]:
        """Per-feature empirical latency samples (observed values only)."""
        out = {}
        for k in self.keys:
            s = self.series(k)
            out[k] = s[np.isfinite(s)]
        return out

    def fires(self, key: FeatureKey, threshold: float) -> np.ndarray:
        s = self.series(key)
        return np.where(np.isfinite(s), s > threshold, False)


# ---------------------------------------------------------------------------
# regime detection: mean-shift split points
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegimeSplit:
    """The best mean-shift split of one series: samples [0, split) vs
    [split, n), their means, and the standardized shift score."""

    split: int
    mean_pre: float
    mean_post: float
    score: float

    @property
    def lift(self) -> float:
        """Post/pre mean ratio (inf when the pre-regime mean is 0)."""
        if self.mean_pre <= 0.0:
            return float("inf") if self.mean_post > 0.0 else 1.0
        return self.mean_post / self.mean_pre


def detect_regimes(values: Sequence[float], *, min_seg: int = 3
                   ) -> RegimeSplit | None:
    """Best single mean-shift split point of a series (CUSUM-style binary
    segmentation): the split s maximizing the standardized statistic
    ``sqrt(s * (n - s) / n) * |mean(left) - mean(right)| / sd`` with at
    least ``min_seg`` finite samples on each side.  NaNs (requests where
    the feature was unobserved) are ignored for the means but keep their
    index, so the returned ``split`` indexes the original series.
    Returns None when fewer than ``2 * min_seg`` finite samples exist.
    """
    v = np.asarray(list(values), np.float64)
    finite = np.isfinite(v)
    if int(finite.sum()) < 2 * min_seg:
        return None
    sd = float(np.std(v[finite]))
    scale = sd if sd > 0.0 else 1.0
    best: RegimeSplit | None = None
    idx = np.flatnonzero(finite)
    for pos in range(min_seg, len(idx) - min_seg + 1):
        left, right = v[idx[:pos]], v[idx[pos:]]
        m_l, m_r = float(left.mean()), float(right.mean())
        w = np.sqrt(len(left) * len(right) / float(len(idx)))
        score = float(w * abs(m_r - m_l) / scale)
        if best is None or score > best.score:
            best = RegimeSplit(split=int(idx[pos]), mean_pre=m_l,
                               mean_post=m_r, score=score)
    return best


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One candidate explanation: ``feature > threshold`` since ``shift_at``."""

    key: FeatureKey
    threshold: float
    shift_at: float
    split: RegimeSplit


def candidate_predicates(ds: BreachDataset, *, min_seg: int = 3,
                         min_lift: float = 1.2,
                         min_score: float = 1.0) -> list[Predicate]:
    """One predicate per feature whose series shifted *up*: threshold at
    the regime-mean midpoint, shift time at the split's request.  Features
    that never slowed (lift below ``min_lift`` or a weak standardized
    score) produce no candidate — they cannot explain a latency breach.
    """
    out = []
    for key in ds.keys:
        sp = detect_regimes(ds.series(key), min_seg=min_seg)
        if sp is None or sp.score < min_score or sp.lift < min_lift:
            continue
        thr = 0.5 * (sp.mean_pre + sp.mean_post)
        out.append(Predicate(key=key, threshold=float(thr),
                             shift_at=float(ds.times[sp.split]), split=sp))
    return out


# ---------------------------------------------------------------------------
# culprit search: BnB (exact) with a GA fallback for large fleets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Culprit:
    """One selected predicate, scored alone against the breach set."""

    worker: int
    phase: str
    layer: int
    threshold: float
    shift_at: float
    coverage: float   # fraction of breaches this predicate alone fires on
    precision: float  # of this predicate alone
    recall: float     # == coverage

    def describe(self) -> str:
        return (f"worker {self.worker}'s {self.phase} phase (layer "
                f"{self.layer}) after t={self.shift_at:g} explains "
                f"{self.coverage:.0%} of breaches")


@dataclasses.dataclass(frozen=True)
class CulpritReport:
    """The ranked explanation of an SLO breach set."""

    culprits: tuple
    precision: float
    recall: float
    f1: float
    n_breaches: int
    n_requests: int
    method: str  # "bnb" | "ga" | "none"

    def to_json(self) -> str:
        """Deterministic bytes: key-sorted JSON of the ranked report."""
        return json.dumps({
            "culprits": [dataclasses.asdict(c) for c in self.culprits],
            "precision": self.precision, "recall": self.recall,
            "f1": self.f1, "n_breaches": self.n_breaches,
            "n_requests": self.n_requests, "method": self.method,
        }, sort_keys=True, separators=(",", ":"))

    def describe(self) -> str:
        if not self.culprits:
            return "no culprit found"
        lines = [c.describe() for c in self.culprits]
        return (f"{'; '.join(lines)} [set precision {self.precision:.0%}, "
                f"recall {self.recall:.0%}]")


def _f1(pred: np.ndarray, breach: np.ndarray) -> tuple[float, float, float]:
    tp = int(np.sum(pred & breach))
    fp = int(np.sum(pred & ~breach))
    fn = int(np.sum(~pred & breach))
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return f, p, r


def _search_bnb(fires: np.ndarray, breach: np.ndarray) -> tuple[float, tuple]:
    """Exact best predicate subset by DFS with an admissible bound.

    Selecting more predicates can only grow the fired union, so from a
    partial state the best reachable F1 is bounded by taking every
    remaining predicate's true positives for free while keeping the
    already-incurred false positives:  F1 <= 2·TP_max / (TP_max + FP_now
    + B).  Ties break toward fewer predicates, then lexicographic order
    (the caller pre-sorts), so the winner is deterministic.
    """
    m = fires.shape[0]
    b_total = int(breach.sum())
    best = {"f1": 0.0, "sel": ()}

    def visit(i: int, pred: np.ndarray, sel: tuple) -> None:
        f, _, _ = _f1(pred, breach) if sel else (0.0, 0.0, 0.0)
        if sel and (f > best["f1"] + 1e-12
                    or (abs(f - best["f1"]) <= 1e-12 and best["sel"]
                        and len(sel) < len(best["sel"]))):
            best["f1"], best["sel"] = f, sel
        if i == m:
            return
        # bound: all remaining TPs gained, no new FPs charged
        rest = pred.copy()
        for j in range(i, m):
            rest |= fires[j]
        tp_max = int(np.sum(rest & breach))
        fp_now = int(np.sum(pred & ~breach))
        bound = (2 * tp_max / (tp_max + fp_now + b_total)
                 if tp_max + fp_now + b_total else 0.0)
        if bound <= best["f1"] + 1e-12 and best["sel"]:
            return
        visit(i + 1, pred | fires[i], sel + (i,))   # include-first
        visit(i + 1, pred, sel)
    visit(0, np.zeros(fires.shape[1], bool), ())
    return best["f1"], best["sel"]


def _search_ga(fires: np.ndarray, breach: np.ndarray, *, seed: int,
               pop: int = 48, gens: int = 80,
               mut: float = 0.05) -> tuple[float, tuple]:
    """Seeded genetic search over predicate bitmasks (large fleets where
    2^m is out of reach).  Deterministic in (fires, breach, seed)."""
    rng = np.random.default_rng(seed)
    m = fires.shape[0]

    def fitness(mask: np.ndarray) -> float:
        if not mask.any():
            return 0.0
        pred = np.any(fires[mask], axis=0)
        f, _, _ = _f1(pred, breach)
        # light parsimony pressure: among equal-F1 masks prefer smaller
        return f - 1e-9 * int(mask.sum())

    population = rng.random((pop, m)) < 0.3
    # seed singletons so strong lone predicates survive generation 0
    for j in range(min(m, pop)):
        population[j] = False
        population[j, j] = True
    for _ in range(gens):
        scores = np.asarray([fitness(ind) for ind in population])
        order = np.argsort(-scores, kind="stable")
        elite = population[order[:max(2, pop // 8)]]
        children = [e.copy() for e in elite]
        while len(children) < pop:
            a, b = rng.integers(0, len(elite), 2)
            cross = rng.random(m) < 0.5
            child = np.where(cross, elite[a], elite[b])
            child ^= rng.random(m) < mut
            children.append(child)
        population = np.asarray(children[:pop])
    scores = np.asarray([fitness(ind) for ind in population])
    best = population[int(np.argmax(scores))]
    sel = tuple(int(j) for j in np.flatnonzero(best))
    if not sel:
        return 0.0, ()
    f, _, _ = _f1(np.any(fires[list(sel)], axis=0), breach)
    return f, sel


def search_culprits(ds: BreachDataset,
                    predicates: Sequence[Predicate] | None = None, *,
                    max_exact: int = 16, seed: int = 0,
                    **candidate_kw) -> CulpritReport:
    """Best-F1 predicate subset against the dataset's breach flags.

    ``predicates`` defaults to :func:`candidate_predicates`.  Exact
    branch-and-bound when at most ``max_exact`` candidates survive the
    regime filter; the seeded GA beyond that.  The report ranks the
    selected culprits by breach coverage (ties by key) and is a
    deterministic function of the inputs.
    """
    if predicates is None:
        predicates = candidate_predicates(ds, **candidate_kw)
    preds = sorted(predicates, key=lambda p: p.key)
    n_breach = int(ds.breach.sum())
    if not preds or n_breach == 0:
        return CulpritReport(culprits=(), precision=0.0, recall=0.0, f1=0.0,
                             n_breaches=n_breach, n_requests=len(ds),
                             method="none")
    fire_rows = np.asarray([ds.fires(p.key, p.threshold) for p in preds])
    # stable pre-sort: strongest lone predicate first, key order on ties —
    # makes BnB's include-first dive land near the optimum immediately
    solo = [_f1(fire_rows[i], ds.breach)[0] for i in range(len(preds))]
    order = sorted(range(len(preds)), key=lambda i: (-solo[i], preds[i].key))
    preds = [preds[i] for i in order]
    fire_rows = fire_rows[order]
    if len(preds) <= max_exact:
        f1, sel = _search_bnb(fire_rows, ds.breach)
        method = "bnb"
    else:
        f1, sel = _search_ga(fire_rows, ds.breach, seed=seed)
        method = "ga"
    if not sel:
        return CulpritReport(culprits=(), precision=0.0, recall=0.0, f1=0.0,
                             n_breaches=n_breach, n_requests=len(ds),
                             method=method)
    union = np.any(fire_rows[list(sel)], axis=0)
    f, p, r = _f1(union, ds.breach)
    culprits = []
    for i in sel:
        pr = preds[i]
        fires = fire_rows[i]
        _, p_i, r_i = _f1(fires, ds.breach)
        culprits.append(Culprit(
            worker=pr.key.worker, phase=pr.key.phase, layer=pr.key.layer,
            threshold=pr.threshold, shift_at=pr.shift_at,
            coverage=r_i, precision=p_i, recall=r_i))
    culprits.sort(key=lambda c: (-c.coverage, c.worker, c.phase, c.layer))
    return CulpritReport(culprits=tuple(culprits), precision=p, recall=r,
                         f1=f, n_breaches=n_breach, n_requests=len(ds),
                         method=method)


def explain_breaches(rows: Iterable[Mapping[FeatureKey, float]],
                     breach: Sequence[bool],
                     times: Sequence[float] | None = None,
                     **kw) -> CulpritReport:
    """Convenience: rows + breach flags -> ranked culprit report."""
    return search_culprits(BreachDataset(list(rows), breach, times), **kw)
