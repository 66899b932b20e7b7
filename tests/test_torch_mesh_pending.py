"""The one-program backend's reports of runs it did not wait for.

On the card ``MeshExecutor.run_op`` issues a run between two timing events
and returns without waiting; the run's ``RunReport`` is booked from its
events at the next ``settle`` (the engine calls it after each copy to the
host) or when ``last_report`` is read.  Here the events are stand-ins with
the surface the bookkeeping reads (``query``, ``synchronize``,
``elapsed_time``), so the bookkeeping is tested without a card, down to a
serve whose every run is booked the card's way.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.schemes import get_scheme
from repro_torch.dist import MeshExecutor, mesh_exec
from repro_torch.dist.backend import CodedOp
from repro_torch.models.model import ModelConfig
from repro_torch.serving import Engine, Request, ServingScheduler
from repro_torch.telemetry import TraceRecorder

CODE = get_scheme("mds").make(5, 3)
WALL = 0.25  # each stand-in run's time on the card, s (exact in binary)


class StandInEvent:
    """A timing event recorded at ``t`` seconds that has fired or not;
    ``synchronize`` waits for it (counted in ``waits``)."""

    def __init__(self, t: float, fired: bool = True):
        self.t, self.fired, self.waits = t, fired, 0

    def query(self) -> bool:
        return self.fired

    def synchronize(self) -> None:
        self.waits += 1
        self.fired = True

    def elapsed_time(self, end: "StandInEvent") -> float:
        return (end.t - self.t) * 1e3  # ms, as torch.cuda.Event's


def _issue(ex, t0: float, wall: float = WALL, fired: bool = True):
    ex._defer(CODE, (0, 2, 3), StandInEvent(t0), StandInEvent(t0 + wall,
                                                               fired))


def test_settle_delivers_each_report_once_in_run_order():
    seen, sink = [], TraceRecorder()
    with MeshExecutor(dead=(1,)) as ex:
        ex.on_report = seen.append
        ex.trace_sink = sink
        _issue(ex, 0.0, 0.25)
        with ex.chain(2.0):
            _issue(ex, 1.0, 0.5)
        _issue(ex, 2.0, 0.75)
        assert seen == [] and len(ex._pending) == 3
        ex.settle()
        assert [r.wall_s for r in seen] == [0.25, 0.5, 0.75]
        assert [r.t_complete for r in seen] == [0.25, 0.5, 0.75]
        assert [r.t_submit for r in seen] == [0.0, 2.0, 0.0]
        assert ex.last_report is seen[-1]
        ex.settle()
        assert len(seen) == 3  # nothing delivered twice
        assert [s.dur for s in sink.by_name("run")] == [0.25, 0.5, 0.75]
        assert seen[0].subset == [0, 2, 3] and seen[0].failures == [(1, 0.0)]
        assert ex.wait_s == 0.0  # every end event had fired: no wait
        assert len(ex._events) == 6  # each event free for a later run


def test_last_report_books_its_run_and_settle_skips_it():
    seen = []
    with MeshExecutor() as ex:
        # an on_report hook that reads last_report gets the report it is
        # handed, not a later one
        ex.on_report = lambda r: seen.append((r, ex.last_report))
        _issue(ex, 0.0)
        _issue(ex, 1.0, 0.5, fired=False)  # still on the card
        end = ex._pending[-1].end
        rep = ex.last_report
        assert end.waits == 1 and ex.wait_s > 0.0  # the forced wait
        assert rep.wall_s == 0.5
        assert [r.wall_s for r, _ in seen] == [WALL, 0.5]
        assert all(r is read for r, read in seen)
        ex.settle()
        assert end.waits == 1 and len(seen) == 2
        assert ex.last_report is rep


def test_queued_runs_counts_a_run_behind_an_unfinished_one():
    with MeshExecutor() as ex:
        _issue(ex, 0.0, fired=False)  # nothing before it
        assert ex.queued_runs == 0
        _issue(ex, 1.0, fired=False)  # behind an unfinished run
        assert ex.queued_runs == 1
        ex._pending[-1].end.fired = True  # the card caught up
        _issue(ex, 2.0)  # behind a finished run
        assert ex.queued_runs == 1
        ex.settle()
        _issue(ex, 3.0)  # nothing pending: every earlier run finished
        assert ex.queued_runs == 1


def test_pending_reports_are_bounded(monkeypatch):
    monkeypatch.setattr(mesh_exec, "MAX_PENDING", 4)
    seen = []
    with MeshExecutor() as ex:
        ex.on_report = seen.append
        for i in range(3):
            _issue(ex, float(i), fired=False)
        assert seen == []
        _issue(ex, 3.0, fired=False)  # the fourth: waits for the card
        assert len(seen) == 4 and not ex._pending


def test_close_settles():
    seen = []
    ex = MeshExecutor()
    ex.on_report = seen.append
    _issue(ex, 0.0, fired=False)
    ex.close()
    assert [r.wall_s for r in seen] == [WALL]


def test_cpu_run_is_booked_as_it_returns():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 4, 8)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(8, 16)), dtype=torch.float32)
    seen = []
    with MeshExecutor() as ex:
        ex.on_report = seen.append
        ex.run_op(CodedOp("matmul", CODE, x, w))
        ex.run_op(CodedOp("matmul", CODE, x, w))
        assert len(seen) == 2 and not ex._pending and ex.queued_runs == 0
        assert ex.run_count == 2 and ex._events == []


class CardBookedMesh(MeshExecutor):
    """A CPU mesh whose runs are booked the card's way: each run's report
    waits for an end event that has not fired, as a run still on the card,
    until the engine's copy to the host settles them."""

    def _book(self, scheme, subset, wall, t_submit=None):
        if t_submit is None:  # run_op's booking of a CPU run: defer it
            self._defer(scheme, subset, StandInEvent(0.0),
                        StandInEvent(WALL, fired=False))
        else:
            super()._book(scheme, subset, wall, t_submit)


TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, gated=False, dtype=torch.float32,
            coded_n=4, coded_k=2)


def _serve(ex, **kw):
    lens = [4, 4, 7, 7, 5, 9]
    # all arrive at once: the steps a real-clock serve lays out then do
    # not depend on how long its calls took
    reqs = [Request(i, (np.arange(lens[i]) + 3 * i).astype(np.int32) % 64,
                    max_new=3) for i in range(6)]
    eng = Engine(ModelConfig(**TINY), seed=0, executor=ex, device="cpu")
    reports = []
    ex.on_report = reports.append
    res = ServingScheduler(eng, max_seq=16, max_batch=4,
                           master_call_s=0.001, **kw).serve(reqs)
    return eng, res, reports


@pytest.mark.parametrize("kw", [{}, dict(packed=False)],
                         ids=["packed", "grouped"])
def test_serve_books_each_steps_runs_in_that_step(kw):
    with MeshExecutor() as plain:
        _, want, _ = _serve(plain, **kw)
    with CardBookedMesh() as ex:
        eng, res, reports = _serve(ex, **kw)
        assert not ex._pending
        assert len(reports) == ex.run_count == sum(s.runs for s in res.steps)
        assert 0 < ex.queued_runs < ex.run_count
    assert [c.tokens.tolist() for c in res.completions] == \
        [c.tokens.tolist() for c in want.completions]
    assert [(s.runs, s.prefill_runs, s.dispatches) for s in res.steps] == \
        [(s.runs, s.prefill_runs, s.dispatches) for s in want.steps]
    for s in res.steps:
        # the step's reports, and only those, reached its record
        assert s.busy_s == WALL * s.runs
        assert s.prefill_span_s == WALL * s.prefill_runs
        assert 0.0 <= s.wait_s <= s.t_end - s.t_start
    assert sum(s.wait_s for s in res.steps) == pytest.approx(
        eng.wait_s + ex.wait_s, abs=1e-9)
