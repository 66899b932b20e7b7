"""The port's worker pool and ``CodedExecutor`` vs the reference's, on the
virtual clock.

The clock, the fault plans and the pool's time-ordered merge are
framework-free copies, so for the same script the evidence trail of a run —
``t_complete``, ``subset``, ``arrivals``, ``failures``, ``redispatched``,
``assignment``, ``dispatch_count`` — must EQUAL the reference's; the decoded
values are allclose (same tolerance rule as tests/test_torch_coded_ops.py).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (as_np, assert_max_err, coded_tol, make_scheme,
                           to_j, to_t)
from repro import dist as jdist
from repro.core import coded_conv as jcc
from repro.core import coded_linear as jcl
from repro.core import schemes as jschemes
from repro.core import splitting as jsplit
from repro_torch import dist as tdist
from repro_torch.core import coded_conv as tcc
from repro_torch.core import coded_linear as tcl
from repro_torch.core import schemes as tschemes
from repro_torch.core import splitting as tsplit

NAMES = ["lt", "mds", "replication", "uncoded"]


def _executor(mod, n, dead=(1,), straggler=None, per_worker=1.0, **kw):
    straggler = {2: 50.0} if straggler is None else straggler
    return mod.CodedExecutor(
        n, clock=mod.FakeClock(), delay_model=mod.DeterministicDelay(per_worker),
        fault_plan=mod.FaultPlan(dead=frozenset(dead), straggler=straggler),
        **kw)


def _trail(ex):
    r = ex.last_report
    return {
        "t_complete": r.t_complete,
        "t_submit": r.t_submit,
        "subset": list(r.subset),
        "arrivals": [(a.worker, a.piece, a.t) for a in r.arrivals],
        "failures": list(r.failures),
        "redispatched": list(r.redispatched),
        "cancelled": list(r.cancelled),
        "assignment": dict(r.assignment),
        "timings": [(t.worker, t.piece, t.t_dispatch, t.t_compute,
                     t.t_arrival, t.stages) for t in r.timings],
        "dispatch_count": ex.pool.dispatch_count,
        "run_count": ex.run_count,
    }


_tol, _close = coded_tol, assert_max_err


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", [(6, 4), (10, 6)])
def test_conv2d_op_trail_equals_reference(name, n, k):
    ts, js = make_scheme(tschemes, name, n, k), make_scheme(jschemes, name, n, k)
    kw = dict(c_in=3, c_out=4, h_in=8, w_in=40, kernel=3, stride=1, batch=2)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 8, 40)).astype(np.float32)
    w = (rng.normal(size=(4, 3, 3, 3)) / 27 ** 0.5).astype(np.float32)
    tex, jex = _executor(tdist, ts.n), _executor(jdist, js.n)
    try:
        got = tcc.coded_conv2d(to_t(x), to_t(w), ts, tsplit.ConvSpec(**kw),
                               executor=tex)
        want = jcc.coded_conv2d(to_j(x), to_j(w), js, jsplit.ConvSpec(**kw),
                                executor=jex)
        assert _trail(tex) == _trail(jex)
        ref = tcc.conv2d(to_t(x), to_t(w), 1)
        tol = _tol(ts, tex.last_report.subset, 27, as_np(ref))
        _close(got, want, tol, "vs reference")
        _close(got, ref, tol, "vs own uncoded")
    finally:
        tex.close()
        jex.close()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", [(6, 4), (10, 6)])
def test_matmul_op_trail_equals_reference(name, n, k):
    """The pool's piece GEMM is the skinny-GEMM wrapper (plain version on
    the CPU), as the reference's is its Pallas kernel."""
    ts, js = make_scheme(tschemes, name, n, k), make_scheme(jschemes, name, n, k)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(45, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 10)) / 5).astype(np.float32)
    tex, jex = _executor(tdist, ts.n), _executor(jdist, js.n)
    try:
        got = tcl.coded_matmul(to_t(x), to_t(w), ts, executor=tex)
        want = jcl.coded_matmul(to_j(x), to_j(w), js, executor=jex)
        assert _trail(tex) == _trail(jex)
        tol = _tol(ts, tex.last_report.subset, 24, x @ w)
        _close(got, want, tol, "vs reference")
        _close(got, to_t(x) @ to_t(w), tol, "vs own uncoded")
    finally:
        tex.close()
        jex.close()


def test_headline_timeline_is_pinned():
    """(10, 6) MDS, worker 1 dead, worker 2 fifty times slow: completion at
    the 6th arrival, t = 1.0; the dead worker's piece is absorbed by the
    code's redundancy (no re-dispatch); the straggler is cancelled."""
    ts = tschemes.MDSScheme(10, 6)
    tex = _executor(tdist, 10)
    try:
        x, w = torch.ones(13, 4), torch.ones(4, 3)
        y = tcl.coded_matmul(x, w, ts, executor=tex)
        r = tex.last_report
        assert r.t_complete == 1.0
        assert r.subset == [0, 3, 4, 5, 6, 7]
        assert r.failures == [(1, 1.0)] and r.redispatched == []
        assert 2 in r.cancelled and tex.pool.dispatch_count == 10
        _close(y, x @ w, 1e-4, "decoded")
    finally:
        tex.close()


@pytest.mark.parametrize("name", NAMES)
def test_two_dead_workers_redispatch_like_reference(name):
    ts, js = make_scheme(tschemes, name, 6, 4), make_scheme(jschemes, name, 6, 4)
    tex = _executor(tdist, ts.n, dead=(0, 3), straggler={})
    jex = _executor(jdist, js.n, dead=(0, 3), straggler={})
    try:
        x = np.random.default_rng(1).normal(size=(24, 6)).astype(np.float32)
        w = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)
        got = tcl.coded_matmul(to_t(x), to_t(w), ts, executor=tex)
        want = jcl.coded_matmul(to_j(x), to_j(w), js, executor=jex)
        assert _trail(tex) == _trail(jex)
        _close(got, want, _tol(ts, tex.last_report.subset, 6, x @ w), "value")
    finally:
        tex.close()
        jex.close()


@pytest.mark.parametrize("mod_name", ["port", "reference"])
def test_undecodable_when_too_many_are_dead(mod_name):
    dist, schemes, to = ((tdist, tschemes, to_t) if mod_name == "port"
                         else (jdist, jschemes, to_j))
    ex = _executor(dist, 4, dead=(0, 1, 2, 3), straggler={})
    try:
        pieces = [lambda i=i: to(np.full((2, 2), float(i))) for i in range(4)]
        with pytest.raises(dist.Undecodable):
            ex.run(schemes.MDSScheme(4, 2), pieces)
    finally:
        ex.close()


def test_hetero_assignment_and_speeds_equal_reference():
    ts, js = tschemes.MDSScheme(8, 5), jschemes.MDSScheme(8, 5)
    x = np.random.default_rng(4).normal(size=(5, 3, 7)).astype(np.float32)
    trails = []
    outs = []
    for dist, scheme, to in ((tdist, ts, to_t), (jdist, js, to_j)):
        ex = _executor(dist, 4, dead=(), straggler={3: 4.0},
                       per_worker=[1.0, 1.0, 2.0, 1.0])
        try:
            coded = scheme.encode(to(x.reshape(5, -1))).reshape(8, 3, 7)
            fns = [lambda i=i: coded[i] for i in range(8)]
            out = ex.run(scheme, fns, speeds=[4.0, 2.0, 1.0, 1.0])
            trails.append(_trail(ex))
            out2 = ex.run(scheme, fns, assignment=[2, 2, 2, 2], gather_all=True)
            trails.append(_trail(ex))
            outs.append((as_np(out), as_np(out2)))
        finally:
            ex.close()
    assert trails[0] == trails[2] and trails[1] == trails[3]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, x, rtol=1e-3, atol=1e-3)


def test_chained_and_grouped_runs_equal_reference():
    """run_async inside pool.group() + chain(): contention and dependency
    gates land on the same virtual instants in both packages."""
    trails = []
    for dist, schemes, to in ((tdist, tschemes, to_t), (jdist, jschemes, to_j)):
        scheme = schemes.MDSScheme(4, 2)
        ex = _executor(dist, 4, dead=(), straggler={0: 3.0})
        try:
            fns = [lambda i=i: to(np.full((2, 3), float(i))) for i in range(4)]
            with ex.pool.group():
                h1 = ex.run_async(scheme, fns)
                h2 = ex.run_async(scheme, fns, decode_chunks=2)
                h1.result()
                t1 = _trail(ex)
                h2.result()
                t2 = _trail(ex)
            with ex.chain(start=0.5):
                ex.run(scheme, fns)
                t3 = _trail(ex)
                ex.run(scheme, fns)
                t4 = _trail(ex)
            trails.append((t1, t2, t3, t4))
        finally:
            ex.close()
    assert trails[0] == trails[1]
    assert trails[0][3]["t_submit"] == trails[0][2]["t_complete"]


@pytest.mark.parametrize("name", ["replication", "uncoded", "mds"])
def test_run_segment_on_the_pool_equals_reference(name):
    ts, js = make_scheme(tschemes, name, 6, 3), make_scheme(jschemes, name, 6, 3)
    linear = name == "mds"
    def chain(mod):
        p = 0 if linear else 1
        a = mod.ConvSpec(c_in=3, c_out=4, h_in=20 + 2 * p, w_in=20 + 2 * p,
                         kernel=3, stride=1)
        s = a.w_out
        b = mod.ConvSpec(c_in=4, c_out=4, h_in=s + 2 * p, w_in=s + 2 * p,
                         kernel=3, stride=1)
        return [a, b], [p, p], ([None, None] if linear else ["relu", "relu"])
    tspecs, pads, acts = chain(tsplit)
    jspecs, _, _ = chain(jsplit)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 3, tspecs[0].h_in, tspecs[0].w_in)).astype(np.float32)
    ws = [(rng.normal(size=(4, 3, 3, 3)) / 27 ** .5).astype(np.float32),
          (rng.normal(size=(4, 4, 3, 3)) / 6).astype(np.float32)]
    tex, jex = _executor(tdist, ts.n), _executor(jdist, js.n)
    try:
        got = tcc.run_segment(to_t(x), [to_t(w) for w in ws], ts, tspecs, pads,
                              acts, executor=tex, stream_chunks=2)
        want = jcc.run_segment(to_j(x), [to_j(w) for w in ws], js, jspecs, pads,
                               acts, executor=jex, stream_chunks=2)
        assert _trail(tex) == _trail(jex)
        local = tcc.run_segment(to_t(x), [to_t(w) for w in ws], ts, tspecs,
                                pads, acts)
        tol = _tol(ts, tex.last_report.subset, 36 * 27, as_np(local))
        _close(got, want, tol, "pool segment vs reference")
        _close(got, local, tol, "pool segment vs functional")
    finally:
        tex.close()
        jex.close()


def test_elastic_lt_run_equals_reference():
    """A joiner receives a fresh LT piece (scheme.extend); a resident
    departs mid-run: same trail, same decode, both packages."""
    trails, outs = [], []
    x = np.random.default_rng(6).normal(size=(3, 10)).astype(np.float32)
    for dist, schemes, to in ((tdist, tschemes, to_t), (jdist, jschemes, to_j)):
        scheme = schemes.LTScheme.make(5, 3)
        ex = dist.CodedExecutor(5, clock=dist.FakeClock(),
                                delay_model=dist.DeterministicDelay(1.0),
                                elastic=True)
        try:
            src = to(x)
            def piece(s, i):
                return lambda: s.encode(src)[i]
            churn = dist.ChurnSchedule((dist.ChurnEvent(0.25, "remove", 0),
                                        dist.ChurnEvent(0.5, "join")))
            h = ex.run_elastic(scheme, [piece(scheme, i) for i in range(5)],
                               churn=churn, fresh_piece=piece)
            outs.append(as_np(h.result()))
            trails.append(_trail(ex))
        finally:
            ex.close()
    assert trails[0] == trails[1]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0], x, rtol=1e-3, atol=1e-3)


def test_backend_seam_and_decodable_prefix():
    ts, js = tschemes.LTScheme.make(6, 3), jschemes.LTScheme.make(6, 3)
    for order in ([0, 1, 2], [5, 4, 3, 2, 1, 0], [2, 2, 2], [1, 3]):
        assert tdist.decodable_prefix(ts, order) == \
            jdist.decodable_prefix(js, order)
    with pytest.raises(ValueError):
        tdist.CodedOp("softmax", ts, torch.zeros(3, 2, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        tdist.CodedOp("conv2d", ts, torch.zeros(3, 1, 1, 4, 4),
                      torch.zeros(1, 1, 3, 3))

    class Legacy:  # a pre-seam executor: thunk list only
        def run(self, scheme, fns, assignment=None, decode_chunks=1):
            sub = scheme.default_subset()
            return tschemes.decode_blocks(
                scheme, sub, torch.stack([fns[i]() for i in sub]))

    x = torch.arange(24.0).reshape(3, 4, 2)
    w = torch.ones(2, 5)
    got = tdist.run_coded_op(Legacy(), tdist.CodedOp("matmul", ts, x, w))
    np.testing.assert_allclose(as_np(got), as_np(x @ w), rtol=1e-4, atol=1e-4)
    ex = _executor(tdist, 6)
    try:
        assert isinstance(ex, tdist.ExecBackend)
        assert ex.plan_matmul(ts, "lt", 12, 2, 5) == (None, None, None)
    finally:
        ex.close()


def test_arrival_waits_for_the_device():
    """pool._wait_for_device is the port's one change to the pool: a CPU
    result needs no wait, and anything that is not a tensor passes."""
    from repro_torch.dist.pool import _wait_for_device

    _wait_for_device(torch.ones(2))
    _wait_for_device(3.0)
    _wait_for_device(None)
