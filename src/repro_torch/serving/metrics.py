"""SLO telemetry for serving-under-load runs (the port of
``repro.serving.metrics``, a numpy copy).

Turns a :class:`~repro_torch.serving.scheduler.ServeResult` into the
numbers a deadline-driven serving story is judged on:

* **TTFT** — arrival -> first token (queue wait + prefill);
* **TPOT** — steady-state seconds per generated token after the first;
* **e2e** — arrival -> last token;
* **goodput** — completed requests *within the deadline SLO* per second,
  plus the attainment fraction;
* **queue/batch timelines** — per-step queue depth and batch occupancy;
* **dispatch accounting** — pool pieces and executor runs per step (n
  pieces per coded GEMM per step, never B·n);
* **membership & epochs** — the fleet-size timeline, the applied
  churn/autoscale events, and per-epoch goodput buckets.

All percentiles use numpy's linear interpolation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .scheduler import ServeResult

__all__ = ["percentiles", "summarize", "slo_violations", "epoch_summary"]

PCTS = (50.0, 95.0, 99.0)


def percentiles(xs: Sequence[float], pcts: Sequence[float] = PCTS) -> dict:
    """{"p50": ..., "p95": ..., "p99": ...} (NaN-free; empty -> zeros)."""
    if len(xs) == 0:
        return {f"p{int(p)}": 0.0 for p in pcts}
    arr = np.asarray(list(xs), np.float64)
    return {f"p{int(p)}": float(np.percentile(arr, p)) for p in pcts}


def summarize(result: ServeResult, *, deadline_s: float | None = None,
              ttft_deadline_s: float | None = None,
              epoch_s: float | None = None,
              scenario: str | None = None) -> dict:
    """One load test -> a JSON-ready SLO report.

    ``deadline_s`` is the end-to-end SLO (arrival -> last token) goodput is
    scored against; ``ttft_deadline_s`` optionally scores first-token
    attainment separately.  Omitted deadlines skip those entries rather
    than inventing a default SLO.  ``epoch_s`` additionally buckets
    completions by their done-time into epochs of that width and reports
    per-epoch goodput/attainment (needs ``deadline_s``) — the evidence an
    elastic fleet HELD goodput through a churn trace rather than merely
    averaging over the collapse.  ``scenario`` labels the report
    (MLPerf-style "offline" / "server") so per-scenario SLO attainment
    stays attributable when several runs land in one results file.
    """
    recs = result.records
    steps = result.steps
    duration = max(result.t_end, 1e-12)
    n = len(recs)
    tokens = int(sum(r.n_tokens for r in recs))
    out: dict = {
        **({"scenario": str(scenario)} if scenario is not None else {}),
        "requests": n,
        "duration_s": float(result.t_end),
        "tokens": tokens,
        "throughput_rps": n / duration,
        "throughput_tok_s": tokens / duration,
        "ttft_s": percentiles([r.ttft_s for r in recs]),
        "tpot_s": percentiles([r.tpot_s for r in recs if r.n_tokens > 1]),
        "e2e_s": percentiles([r.e2e_s for r in recs]),
        "ttft_mean_s": float(np.mean([r.ttft_s for r in recs])) if n else 0.0,
        "queue_wait_mean_s": (float(np.mean([r.admit_s - r.arrival_s
                                             for r in recs])) if n else 0.0),
    }
    if deadline_s is not None:
        met = sum(1 for r in recs if r.e2e_s <= deadline_s)
        out["slo_deadline_s"] = float(deadline_s)
        out["goodput_rps"] = met / duration
        out["slo_attainment"] = met / n if n else 0.0
    if ttft_deadline_s is not None:
        met = sum(1 for r in recs if r.ttft_s <= ttft_deadline_s)
        out["ttft_deadline_s"] = float(ttft_deadline_s)
        out["ttft_attainment"] = met / n if n else 0.0
    if steps:
        depth = [s.queue_depth for s in steps]
        batch = [s.batch for s in steps]
        out["steps"] = len(steps)
        out["queue_depth"] = {"mean": float(np.mean(depth)),
                              "max": int(max(depth))}
        out["batch_occupancy"] = {"mean": float(np.mean(batch)),
                                  "max": int(max(batch))}
        out["queue_timeline"] = [[float(s.t_start), int(s.queue_depth)]
                                 for s in steps]
        out["dispatches_total"] = int(sum(s.dispatches for s in steps))
        out["runs_total"] = int(sum(s.runs for s in steps))
        busy = [s for s in steps if s.batch > 0]
        out["dispatches_per_step_mean"] = (
            float(np.mean([s.dispatches for s in busy])) if busy else 0.0)
        # -- per-step time-attribution percentiles (DESIGN.md §15): where
        # a step's time went — pool makespan vs serial-equivalent
        # occupancy vs streaming-hidden overlap vs master-side work —
        # the distributions the tail-latency explainer starts from.
        out["step_span_s"] = percentiles([s.span_s for s in steps])
        out["step_busy_s"] = percentiles([s.busy_s for s in steps])
        out["step_overlap_s"] = percentiles([s.overlap_s for s in steps])
        out["step_master_s"] = percentiles([s.master_s for s in steps])
        # -- prefill-efficiency telemetry (DESIGN.md §14).  prefix_hit_rate
        # is token-weighted: skipped prefill positions over all prompt
        # tokens served — the fraction of prefill work the cache deleted.
        out["prefill_dispatches_total"] = int(
            sum(s.prefill_dispatches for s in steps))
        out["packed_tokens_total"] = int(
            sum(s.packed_tokens for s in steps))
        out["packed_pad_tokens_total"] = int(
            sum(s.packed_pad_tokens for s in steps))
        out["prefill_chunks_total"] = int(
            sum(s.prefill_chunks for s in steps))
        hit_tokens = int(sum(s.prefix_hit_tokens for s in steps))
        out["prefix_hit_tokens_total"] = hit_tokens
        prompt_tokens = int(sum(r.prompt_len for r in recs))
        out["prefix_hit_rate"] = (hit_tokens / prompt_tokens
                                  if prompt_tokens else 0.0)
        out["cache_evictions_total"] = int(
            sum(s.cache_evictions for s in steps))
        out["cache_bytes_final"] = int(steps[-1].cache_bytes)
        alive = [s.alive for s in steps]
        if any(alive):
            out["alive_timeline"] = [[float(s.t_start), int(s.alive)]
                                     for s in steps]
            out["alive_workers"] = {"min": int(min(alive)),
                                    "max": int(max(alive)),
                                    "mean": float(np.mean(alive))}
    membership = getattr(result, "membership", None)
    if membership:
        out["membership"] = [[float(t), str(a), int(w)]
                             for (t, a, w) in membership]
    if epoch_s is not None and deadline_s is not None and recs:
        out["epochs"] = epoch_summary(result, deadline_s=deadline_s,
                                      epoch_s=epoch_s)
    return out


def slo_violations(result: ServeResult, *,
                   ttft_slo_s: float | None = None,
                   tpot_slo_s: float | None = None) -> list[int]:
    """Request ids that violated either SLO — the breach set the
    tail-latency explainer (telemetry/explain.py) consumes.

    A request violates when its TTFT exceeds ``ttft_slo_s`` or its TPOT
    exceeds ``tpot_slo_s`` (omitted SLOs are not checked; at least one
    must be given).  Returns sorted rids.
    """
    if ttft_slo_s is None and tpot_slo_s is None:
        raise ValueError("pass ttft_slo_s and/or tpot_slo_s — with no SLO "
                         "there is nothing to violate")
    out = set()
    for r in result.records:
        if ttft_slo_s is not None and r.ttft_s > ttft_slo_s:
            out.add(r.rid)
        if (tpot_slo_s is not None and r.n_tokens > 1
                and r.tpot_s > tpot_slo_s):
            out.add(r.rid)
    return sorted(out)


def epoch_summary(result: ServeResult, *, deadline_s: float,
                  epoch_s: float) -> list[dict]:
    """Per-epoch goodput: completions bucketed by done-time.

    Each epoch reports the requests that FINISHED inside it, how many met
    the e2e deadline, and the resulting goodput — the time-resolved view
    ``summarize``'s whole-run goodput averages away.  Epochs run from 0 to
    ``result.t_end`` in ``epoch_s`` strides; empty epochs are kept (zero
    goodput during a stall is the finding, not noise).
    """
    if epoch_s <= 0:
        raise ValueError(f"need epoch_s > 0, got {epoch_s}")
    n_epochs = max(1, int(np.ceil(result.t_end / epoch_s)))
    buckets: list[list] = [[] for _ in range(n_epochs)]
    for r in result.records:
        e = min(int(r.done_s / epoch_s), n_epochs - 1)
        buckets[e].append(r)
    out = []
    for e, rs in enumerate(buckets):
        met = sum(1 for r in rs if r.e2e_s <= deadline_s)
        out.append({
            "t0": e * epoch_s,
            "t1": min((e + 1) * epoch_s, result.t_end),
            "completed": len(rs),
            "met": met,
            "goodput_rps": met / epoch_s,
            "attainment": met / len(rs) if rs else None,
        })
    return out
