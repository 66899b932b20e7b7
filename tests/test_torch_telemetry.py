"""The port's span traces vs the reference's, on the virtual clock.

Mirrors the threads half of tests/test_telemetry.py: the golden pool
scenario (``CodedExecutor(4)`` on a staggered ``DeterministicDelay`` pool,
one mds(4, 2) run, the sink on the executor and on the pool) must export
JSONL equal byte for byte to ``tests/golden/trace_pool.jsonl``, the same
bytes on every run, and a Chrome trace of the reference's schema.  A sink
set on the pool alone, or on the executor alone, must leave the run's
result intact.  On a segment-delay pool (per-stage "phase" spans) and with
a dead worker and a straggler, the port's spans equal the reference's.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro import dist as jdist
from repro import telemetry as jtel
from repro.core import latency as jlat
from repro.core import schemes as jschemes
from repro_torch import dist as tdist
from repro_torch import telemetry as ttel
from repro_torch.core import latency as tlat
from repro_torch.core import schemes as tschemes

GOLDEN = pathlib.Path(__file__).parent / "golden" / "trace_pool.jsonl"
N, K = 4, 2
WIFI = dict(mu_m=2.5e9, theta_m=4e-10, mu_cmp=4e9, theta_cmp=1.35e-9,
            mu_rec=1.5e7, theta_rec=3e-7, mu_sen=1.5e7, theta_sen=3e-7)


def _pool_trace(on_pool=True, on_exec=True):
    """The golden scenario; returns (recorder, decoded result)."""
    rec = ttel.TraceRecorder()
    with tdist.CodedExecutor(N, clock=tdist.FakeClock(),
                             delay_model=tdist.DeterministicDelay(
                                 [0.01, 0.02, 0.03, 0.04])) as ex:
        if on_exec:
            ex.trace_sink = rec
        if on_pool:
            ex.pool.trace_sink = rec
        out = ex.run(tschemes.get_scheme("mds").make(N, K),
                     [lambda i=i: torch.full((2, 2), float(i + 1))
                      for i in range(N)])
    return rec, out


def _untraced_result():
    with tdist.CodedExecutor(N, clock=tdist.FakeClock(),
                             delay_model=tdist.DeterministicDelay(
                                 [0.01, 0.02, 0.03, 0.04])) as ex:
        return ex.run(tschemes.get_scheme("mds").make(N, K),
                      [lambda i=i: torch.full((2, 2), float(i + 1))
                       for i in range(N)])


class TestTraceExport:
    def test_jsonl_matches_golden(self):
        rec, _ = _pool_trace()
        assert ttel.to_jsonl(rec.spans) == GOLDEN.read_text()

    def test_byte_identical_across_runs(self):
        a, _ = _pool_trace()
        b, _ = _pool_trace()
        assert ttel.to_jsonl(a.spans) == ttel.to_jsonl(b.spans)

    def test_pool_spans_pinned(self):
        rec, _ = _pool_trace()
        runs = rec.by_name("run")
        assert len(runs) == 1
        # k=2: the run completes at the 2nd-fastest worker's arrival
        assert runs[0].t0 == 0.0 and runs[0].dur == pytest.approx(0.02)
        assert runs[0].args["n"] == N and runs[0].args["k"] == K
        pieces = rec.by_name("piece")
        assert pieces
        for p in pieces:
            assert p.tid.startswith("worker-")
            assert p.t0 >= 0.0 and p.dur > 0.0

    def test_chrome_trace_schema(self):
        rec, _ = _pool_trace()
        doc = ttel.to_chrome_trace(rec.spans)
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        assert doc["displayTimeUnit"] == "ms"
        events = doc["traceEvents"]
        meta = [e for e in events if e["ph"] == "M"]
        complete = [e for e in events if e["ph"] == "X"]
        assert len(meta) + len(complete) == len(events)
        assert events[:len(meta)] == meta
        assert all(e["name"] == "thread_name" for e in meta)
        tids = {e["tid"] for e in meta}
        assert tids == set(range(len(meta)))
        # workers first, in numeric order, then the pool's own track
        assert [e["args"]["name"] for e in meta] == [
            "worker-0", "worker-1", "pool"]
        for e in complete:
            assert set(e) == {"name", "cat", "ph", "ts", "dur", "pid",
                              "tid", "args"}
            assert e["tid"] in tids
            assert e["ts"] >= 0.0 and e["dur"] >= 0.0
        assert [e["ts"] for e in complete] == [s.t0 * 1e6 for s in rec.spans]
        json.dumps(doc)
        jdoc = jtel.to_chrome_trace(
            [jtel.trace.Span(**s.to_dict()) for s in rec.spans])
        assert json.dumps(doc, sort_keys=True) == json.dumps(jdoc,
                                                             sort_keys=True)

    def test_recorder_helpers(self):
        rec, _ = _pool_trace()
        assert len(rec) == len(rec.spans) > 0
        assert rec.by_name("nope") == []
        rec.origin = 5.0
        rec.clear()
        assert len(rec) == 0 and rec.origin == 0.0

    def test_recorder_is_a_sink_and_origin_shifts_spans(self):
        rec = ttel.TraceRecorder()
        assert isinstance(rec, ttel.TraceSink)
        rec.origin = 2.5
        with tdist.CodedExecutor(N, clock=tdist.FakeClock(),
                                 delay_model=tdist.DeterministicDelay(
                                     [0.01, 0.02, 0.03, 0.04])) as ex:
            ex.trace_sink = rec
            ex.pool.trace_sink = rec
            ex.run(tschemes.get_scheme("mds").make(N, K),
                   [lambda i=i: torch.full((2, 2), float(i + 1))
                    for i in range(N)])
        golden = [json.loads(ln) for ln in GOLDEN.read_text().splitlines()]
        assert [s.t0 for s in rec.spans] == [g["t0"] + 2.5 for g in golden]


class TestSinkKeepsTheResult:
    """A sink on either layer alone used to raise at the first resolved
    run (the module it imports was missing) and lose the result."""

    @pytest.mark.parametrize("on_pool,on_exec,names", [
        (True, False, ["piece", "piece"]),
        (False, True, ["run"]),
        (True, True, ["piece", "piece", "run"]),
    ], ids=["pool-only", "executor-only", "both"])
    def test_result_returned_with_spans(self, on_pool, on_exec, names):
        rec, out = _pool_trace(on_pool, on_exec)
        want = _untraced_result()
        assert torch.equal(out, want)
        assert [s.name for s in rec.spans] == names


def _segment_spans(mod, scheme_mod, lat_mod, tel_mod, tensor):
    """One mds(5, 3) run on a segment-delay pool (stage "phase" spans),
    worker 1 dead and worker 2 a 50x straggler."""
    p = lat_mod.SystemParams(**WIFI)
    lsz = (lat_mod.PhaseSizes(0.0, 2e6, 3e4, 0.0, 0.0),
           lat_mod.PhaseSizes(0.0, 3e6, 0.0, 2e4, 0.0))
    rec = tel_mod.TraceRecorder()
    with mod.CodedExecutor(
            5, clock=mod.FakeClock(),
            delay_model=mod.SegmentDelay(p, lsz, seed=4),
            fault_plan=mod.FaultPlan(dead=frozenset({1}),
                                     straggler={2: 50.0})) as ex:
        ex.trace_sink = rec
        ex.pool.trace_sink = rec
        out = ex.run(scheme_mod.get_scheme("mds").make(5, 3),
                     [lambda i=i: tensor(np.full((2, 3), float(i + 1),
                                                 np.float32))
                      for i in range(5)])
    return rec, out


def test_segment_pool_spans_equal_the_reference():
    trec, tout = _segment_spans(tdist, tschemes, tlat, ttel, torch.from_numpy)
    jrec, jout = _segment_spans(jdist, jschemes, jlat, jtel, jnp.asarray)
    assert trec.by_name("phase"), "no per-stage spans to compare"
    assert ttel.to_jsonl(trec.spans) == jtel.to_jsonl(jrec.spans)
    np.testing.assert_allclose(as_np(tout), as_np(jout), rtol=1e-5,
                               atol=1e-5)
