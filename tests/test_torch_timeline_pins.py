"""Hand-computed FakeClock timelines of the port's pool and executor,
number for number the reference's pins.

Ported from tests/test_pool_overlap.py (overlapping runs on one pool: queue
wait shows as a late ``t_dispatch``, never as ``t_compute``; chains gate
runs to the previous ``t_complete``), tests/test_stream_exec.py (chunked
``SegmentDelay`` / ``ShiftExpDelay`` timelines, streamed segments that
finish strictly earlier with the same bits, cancellation mid-stream) and
tests/test_elastic.py's two pinned churn cells (an MDS removal absorbed
by redundancy, an LT joiner's fresh piece substituting for a leaver).
The wall-clock assertion of the reference's overlapped-serving test is
not ported: the port pins timelines on the virtual clock only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.coded_conv import run_segment
from repro_torch.core.latency import PhaseSizes, SystemParams, pipelined_time
from repro_torch.core.netplan import segment_layer_sizes
from repro_torch.core.schemes import LTScheme, get_scheme
from repro_torch.core.splitting import ConvSpec
from repro_torch.dist import (ChurnEvent, ChurnSchedule, CodedExecutor,
                              DeterministicDelay, FakeClock, FaultPlan,
                              RealClock, SegmentDelay, ShiftExpDelay,
                              WorkerPool, per_layer_sizes)

torch.set_num_threads(1)

WIFI = SystemParams(mu_m=2.5e9, theta_m=4e-10, mu_cmp=4e9, theta_cmp=1.35e-9,
                    mu_rec=1.5e7, theta_rec=3e-7, mu_sen=1.5e7, theta_sen=3e-7)


def _pool(n=4, piece_s=1.0):
    return WorkerPool(n, clock=FakeClock(),
                      delay_model=DeterministicDelay(piece_s))


def _pieces(n, tag=0.0):
    return [lambda i=i: torch.full((4,), tag + i, dtype=torch.float32)
            for i in range(n)]


def _all(n):
    return lambda order: list(order) if len(order) >= n else None


def _rows(base):
    return np.stack([np.full((4,), base + i, np.float32) for i in range(4)])


# -- tests/test_pool_overlap.py ----------------------------------------------

class TestOverlappingPoolRuns:
    def test_two_inflight_runs_share_the_timeline(self):
        with _pool() as pool:
            h1 = pool.run_async(_pieces(4), _all(4))
            h2 = pool.run_async(_pieces(4, tag=10.0), _all(4))
            out2, r2 = h2.result()  # resolve in REVERSE submission order
            out1, r1 = h1.result()
        assert r1.t_complete == 1.0
        assert r2.t_complete == 2.0
        assert [float(out1[i][0]) for i in range(4)] == [0.0, 1.0, 2.0, 3.0]
        assert [float(out2[i][0]) for i in range(4)] == [10.0, 11.0, 12.0,
                                                         13.0]

    def test_queue_wait_is_dispatch_latency_not_compute(self):
        with _pool() as pool:
            h1 = pool.run_async(_pieces(4), _all(4))
            h2 = pool.run_async(_pieces(4), _all(4))
            h1.result()
            _, r2 = h2.result()
        for tm in r2.timings:
            assert tm.t_compute == 1.0
            assert tm.t_dispatch == 1.0
            assert tm.t_arrival == 2.0

    def test_serial_runs_get_fresh_timelines(self):
        with _pool() as pool:
            _, r1 = pool.run(_pieces(4), _all(4))
            _, r2 = pool.run(_pieces(4), _all(4))
        assert r1.t_complete == r2.t_complete == 1.0

    def test_group_persists_worker_time_across_serial_runs(self):
        with _pool() as pool:
            with pool.group():
                _, r1 = pool.run(_pieces(4), _all(4))
                _, r2 = pool.run(_pieces(4), _all(4))
            _, r3 = pool.run(_pieces(4), _all(4))  # group left: fresh
        assert (r1.t_complete, r2.t_complete) == (1.0, 2.0)
        assert r3.t_complete == 1.0

    def test_overlap_is_deterministic(self):
        def run():
            with _pool() as pool:
                h1 = pool.run_async(_pieces(4), _all(4))
                h2 = pool.run_async(_pieces(4), _all(4))
                _, r1 = h1.result()
                _, r2 = h2.result()
            return ([a.piece for a in r1.arrivals], r1.t_complete,
                    [a.piece for a in r2.arrivals], r2.t_complete)

        assert run() == run()

    def test_redispatch_inside_group(self):
        scheme = get_scheme("uncoded").make(4)
        with CodedExecutor(4, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0),
                           fault_plan=FaultPlan(dead=frozenset({1}))) as ex:
            with ex.pool.group():
                out1 = ex.run(scheme, _pieces(4))
                r1 = ex.last_report
                out2 = ex.run(scheme, _pieces(4, tag=5.0))
                r2 = ex.last_report
        for r, base, out in ((r1, 0.0, out1), (r2, 5.0, out2)):
            assert r.failures and r.failures[0][0] == 1
            assert r.redispatched
            np.testing.assert_array_equal(out.numpy(), _rows(base))

    def test_real_clock_overlapping_runs(self):
        with WorkerPool(4, clock=RealClock(),
                        delay_model=DeterministicDelay(0.01)) as pool:
            h1 = pool.run_async(_pieces(4), _all(4))
            h2 = pool.run_async(_pieces(4, tag=10.0), _all(4))
            out2, _ = h2.result()
            out1, _ = h1.result()
        assert float(out1[3][0]) == 3.0
        assert float(out2[3][0]) == 13.0


class TestExecutorOverlap:
    def test_two_executors_share_one_pool(self):
        scheme = get_scheme("uncoded").make(4)
        with _pool() as pool:
            ex1 = CodedExecutor(pool=pool)
            ex2 = CodedExecutor(pool=pool)
            h1 = ex1.run_async(scheme, _pieces(4))
            h2 = ex2.run_async(scheme, _pieces(4, tag=10.0))
            out2 = h2.result()
            out1 = h1.result()
        np.testing.assert_array_equal(out1.numpy(), _rows(0.0))
        np.testing.assert_array_equal(out2.numpy(), _rows(10.0))
        assert ex1.run_count == ex2.run_count == 1
        assert ex1.last_report.t_complete == 1.0
        assert ex2.last_report.t_complete == 2.0

    def test_chain_gates_runs_to_previous_completion(self):
        scheme = get_scheme("uncoded").make(4)
        with CodedExecutor(4, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0)) as ex:
            with ex.pool.group():
                with ex.chain():
                    ex.run(scheme, _pieces(4))
                    first = ex.last_report
                    ex.run(scheme, _pieces(4))
                    second = ex.last_report
        assert first.t_submit == 0.0 and first.t_complete == 1.0
        assert second.t_submit == first.t_complete
        assert second.t_complete == 2.0

    def test_kth_arrival_semantics_survive_overlap(self):
        scheme = get_scheme("mds").make(4, 2)
        data = torch.from_numpy(np.random.default_rng(0).normal(
            size=(2, 8)).astype(np.float32))
        coded = scheme.encode(data)
        fns = [lambda i=i: coded[i] for i in range(4)]
        with CodedExecutor(4, clock=FakeClock(),
                           delay_model=DeterministicDelay(1.0),
                           fault_plan=FaultPlan(straggler={0: 10.0})) as ex:
            h1 = ex.run_async(scheme, fns)
            h2 = ex.run_async(scheme, fns)
            y1 = h1.result()
            r1 = ex.last_report
            y2 = h2.result()
            r2 = ex.last_report
        assert 0 not in r1.subset and 0 not in r2.subset
        assert r1.t_complete == 1.0
        assert r2.t_complete == 2.0
        for y in (y1, y2):
            np.testing.assert_allclose(y.numpy(), data.numpy(),
                                       atol=1e-4, rtol=1e-4)


# -- tests/test_stream_exec.py -----------------------------------------------

def _chain(depth, size, c=8):
    specs, pads, acts, s = [], [], [], size
    for j in range(depth):
        specs.append(ConvSpec(c_in=3 if j == 0 else c, c_out=c,
                              h_in=s + 2, w_in=s + 2, kernel=3, stride=1))
        pads.append(1)
        acts.append("relu")
        s = specs[-1].w_out
    return specs, pads, acts


def _rand_segment(seed, specs):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, specs[0].c_in, specs[0].h_in, specs[0].w_in),
                    generator=gen)
    ws = [torch.randn((s.c_out, s.c_in, s.kernel, s.kernel), generator=gen)
          * (s.c_in * s.kernel ** 2) ** -0.5 for s in specs]
    return x, ws


class TestChunkedDelayModels:
    def _sizes(self):
        return per_layer_sizes([
            PhaseSizes(0.0, 2e6, 4e5, 0.0, 0.0),
            PhaseSizes(0.0, 2e6, 0.0, 4e5, 0.0)])

    def test_segment_delay_stage_times_unchanged(self):
        a = SegmentDelay(WIFI, self._sizes(), seed=3)
        b = dataclasses.replace(a, chunks=4)
        for w in range(3):
            for p in range(4):
                assert a.stage_times(w, p) == b.stage_times(w, p)

    def test_segment_delay_piece_time_is_pipelined_substages(self):
        d = SegmentDelay(WIFI, self._sizes(), seed=3, chunks=4)
        serial = dataclasses.replace(d, chunks=1)
        for w in range(3):
            for p in range(4):
                subs = [t for _, t in d._substage_times(w, p)]
                assert d.piece_time(w, p) == pytest.approx(
                    pipelined_time(subs, 4))
                assert d.piece_time(w, p) <= serial.piece_time(w, p)
                assert sum(d.stage_times(w, p)) == pytest.approx(
                    serial.piece_time(w, p))

    def test_shiftexp_delay_chunked(self):
        sizes = PhaseSizes(0.0, 2e6, 4e5, 4e5, 0.0)
        d = ShiftExpDelay(WIFI, sizes, seed=1, chunks=4)
        serial = dataclasses.replace(d, chunks=1)
        for w in range(3):
            st = d.stage_times(w, 0)
            assert st == serial.stage_times(w, 0)
            assert d.piece_time(w, 0) == pytest.approx(
                pipelined_time(st, 4))
            assert d.piece_time(w, 0) < serial.piece_time(w, 0)


class TestStreamedSegment:
    def test_executor_streamed_matches_and_completes_earlier(self):
        specs, pads, acts = _chain(2, 18)
        x, ws = _rand_segment(5, specs)
        scheme = get_scheme("replication")(6)
        lsz = per_layer_sizes(segment_layer_sizes(specs, pads, scheme))
        outs, times = [], []
        for chunks in (1, 4):
            delay = SegmentDelay(WIFI, lsz, seed=2, chunks=chunks)
            with CodedExecutor(3, clock=FakeClock(),
                               delay_model=delay) as ex:
                outs.append(run_segment(x, ws, scheme, specs, pads, acts,
                                        executor=ex, stream_chunks=chunks))
                times.append(ex.last_report.t_complete)
        assert torch.equal(outs[0], outs[1])
        assert times[1] < times[0]

    def test_streamed_raw_stages_exceed_pipelined_compute(self):
        specs, pads, acts = _chain(2, 18)
        x, ws = _rand_segment(6, specs)
        scheme = get_scheme("uncoded")(4)
        lsz = per_layer_sizes(segment_layer_sizes(specs, pads, scheme))
        delay = SegmentDelay(WIFI, lsz, seed=8, chunks=4)
        with CodedExecutor(4, clock=FakeClock(), delay_model=delay) as ex:
            run_segment(x, ws, scheme, specs, pads, acts, executor=ex,
                        stream_chunks=4)
            report = ex.last_report
        assert report.timings
        for t in report.timings:
            assert len(t.stages) == 2
            assert sum(t.stages) > t.t_compute

    def test_straggler_cancelled_mid_stream(self):
        specs, pads, acts = _chain(2, 18)
        x, ws = _rand_segment(7, specs)
        scheme = get_scheme("replication")(8)
        lsz = per_layer_sizes(segment_layer_sizes(specs, pads, scheme))
        delay = SegmentDelay(WIFI, lsz, seed=5, chunks=4)
        ref = run_segment(x, ws, scheme, specs, pads, acts)
        with CodedExecutor(3, clock=FakeClock(), delay_model=delay,
                           fault_plan=FaultPlan(straggler={0: 50.0})) as ex:
            out = run_segment(x, ws, scheme, specs, pads, acts, executor=ex,
                              stream_chunks=4)
            report = ex.last_report
        np.testing.assert_allclose(out.numpy(), ref.numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert all(report.assignment[p] != 0 for p in report.subset)
        assert report.cancelled


# -- tests/test_elastic.py: the two pinned churn cells ------------------------

F = 6


def _sources(code, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(code.k, F)).astype(np.float32))


def _piece_fns(code, src):
    coded = code.encode(src)
    return [lambda i=i: coded[i] for i in range(code.n)]


def _executor(n_workers):
    return CodedExecutor(n_workers, clock=FakeClock(),
                         delay_model=DeterministicDelay(1.0))


def _assert_decodes(handle, src):
    np.testing.assert_allclose(handle.result().numpy(), src.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_pin_mds_removal_timeline():
    """MDS(4,3) on 2 workers, w1 removed at t=1.5: round-robin puts p0,p2
    on w0 and p1,p3 on w1, every piece takes 1.0.  w1 finishes p1 at 1.0
    and would finish p3 at 2.0 > 1.5, so p3 is lost with the failure AT
    1.5; {0,1,2} decodes, no re-dispatch, and the run completes at p2's
    arrival on w0: t = 2.0 exactly."""
    code = get_scheme("mds").make(4, 3)
    src = _sources(code)
    with _executor(2) as ex:
        ex.pool.remove_worker(1, at=1.5)
        h = ex.run_async(code, _piece_fns(code, src))
        _assert_decodes(h, src)
        r = h.report
    assert r.t_complete == 2.0
    assert r.subset == [0, 1, 2]
    assert r.failures == [(1, 1.5)]
    assert r.redispatched == []


def test_pin_lt_join_timeline():
    """LT(2,2) on 2 workers; a joiner at t=0 takes a fresh extended row,
    w1 departs at t=0.2 before its piece lands.  seed=1 gives independent
    rows {0,2}, so the joiner's fresh piece substitutes for the departed
    resident with no re-dispatch: p0 (w0) and p2 (w2) both finish at 1.0
    and t_complete == 1.0 exactly."""
    code = LTScheme(2, 2, seed=1)
    ext = code.extend(1)
    assert np.linalg.matrix_rank(code.rows) == 2
    assert np.linalg.matrix_rank(ext.rows[[0, 2]]) == 2
    src = _sources(code)
    churn = ChurnSchedule((ChurnEvent(0.0, "join"),
                           ChurnEvent(0.2, "remove", 1)))

    def fresh(ext, idx):
        return lambda: torch.from_numpy(
            np.asarray(ext.rows[idx], np.float32)) @ src

    with _executor(2) as ex:
        h = ex.run_elastic(code, _piece_fns(code, src), churn=churn,
                           fresh_piece=fresh)
        _assert_decodes(h, src)
        r = h.report
    assert r.t_complete == 1.0
    assert r.subset == [0, 2]
    assert r.failures == [(1, 0.2)]
    assert r.redispatched == []
    assert r.assignment == {0: 0, 1: 1, 2: 2}
