"""The port's one-program backend (``repro_torch.dist.MeshExecutor``) on the
CPU, mirroring tests/test_backend_equiv.py.

Both implementations of the ``dist/backend.py`` seam must decode BITWISE
identically for every registered scheme under every modeled fault pattern:
no fault, a dead worker (its piece redispatched, arriving last), a
straggler (arriving after every healthy piece).  The threaded backend
derives the decodable subset from k-th-arrival order on its virtual
clock; the mesh derives the same subset ahead of dispatch from its
configured pattern.  On the CPU the mesh runs its program eagerly on the
kernels' plain versions (the stacked piece GEMM and conv piece by piece),
so equal bytes are the contract.

The reference's own mesh cannot run on this jax (its ``shard_map`` call
passes ``check_rep``), so the same numpy inputs also go through the
reference's *threaded* ``repro.dist.CodedExecutor``, which the reference's
tests pin bitwise to its mesh: the port's mesh must consume the same
subset and agree within the coded tolerance of
``_torch_parity.coded_tol`` (f32 roundoff of the pieces' contraction,
amplified by the decode matrix of that subset, factor 4 of slack).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (as_np, assert_max_err, assert_scaled_close,
                           coded_tol, make_scheme, rounded, sum_coef, to_j,
                           to_t)
from repro import configs as jconfigs
from repro import dist as jdist
from repro.core import coded_conv as jcc
from repro.core import coded_linear as jcl
from repro.core import schemes as jschemes
from repro.core import splitting as jsplit
from repro.kernels.mds_encode import skinny_gemm_pallas
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.core import coded_conv as tcc
from repro_torch.core import coded_linear as tcl
from repro_torch.core import schemes as tschemes
from repro_torch.core import splitting as tsplit
from repro_torch.dist.backend import CodedOp, ExecBackend
from repro_torch.kernels.conv2d import conv2d_stacked
from repro_torch.kernels.skinny_gemm import piece_gemm_stacked, skinny_gemm
from repro_torch.launch import (PIECE_LANES, PiecePlacementError,
                                make_local_mesh)
from repro_torch.serving import Engine, Request
from repro_torch.telemetry import TraceRecorder

N = 5  # pieces per coded op in the equivalence matrix

# (label, threaded FaultPlan kwargs (either package), mesh fault kwargs)
FAULTS = [
    ("none", lambda d: {}, {}),
    ("dead", lambda d: dict(fault_plan=d.FaultPlan(dead=frozenset({1}))),
     dict(dead=(1,))),
    ("straggler", lambda d: dict(fault_plan=d.FaultPlan(straggler={2: 50.0})),
     dict(stragglers=(2,))),
]
FAULT_IDS = [f[0] for f in FAULTS]
CONV = dict(c_in=3, c_out=4, h_in=12, w_in=26, kernel=3, stride=1, batch=2)


def _threads(mod, n, fp_kw):
    return mod.CodedExecutor(n, clock=mod.FakeClock(),
                             delay_model=mod.DeterministicDelay(1.0),
                             **fp_kw(mod))


def _bitwise(a, b):
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _run_three(name, fp_kw, mesh_kw, port_call, ref_call):
    """The same op on the port's threads, the port's mesh and the
    reference's threads: (outputs, subsets, port scheme)."""
    ts = make_scheme(tschemes, name, N, 3)
    js = make_scheme(jschemes, name, N, 3)
    ex_t, ex_m = _threads(tdist, ts.n, fp_kw), tdist.MeshExecutor(**mesh_kw)
    ex_j = _threads(jdist, js.n, fp_kw)
    try:
        outs = (port_call(ts, ex_t), port_call(ts, ex_m), ref_call(js, ex_j))
        subsets = [list(e.last_report.subset) for e in (ex_t, ex_m, ex_j)]
    finally:
        ex_t.close()
        ex_m.close()
        ex_j.close()
    return outs, subsets, ts


@pytest.mark.parametrize("fault,fp_kw,mesh_kw", FAULTS, ids=FAULT_IDS)
@pytest.mark.parametrize("name", tschemes.scheme_names())
class TestCrossBackendBitwise:
    def test_matmul(self, name, fault, fp_kw, mesh_kw):
        rng = np.random.default_rng(11)
        x = rng.normal(size=(13, 8)).astype(np.float32)
        w = rng.normal(size=(8, 16)).astype(np.float32)
        (y_t, y_m, y_j), subsets, ts = _run_three(
            name, fp_kw, mesh_kw,
            lambda s, ex: tcl.coded_matmul(to_t(x), to_t(w), s, executor=ex),
            lambda s, ex: jcl.coded_matmul(to_j(x), to_j(w), s, executor=ex))
        # all three masters consumed the SAME decodable subset...
        assert subsets[0] == subsets[1] == subsets[2]
        # ...the two port backends decoded to the SAME bytes (-0.0 too)...
        assert _bitwise(y_t, y_m)
        # ...and the reference's threads agree within the coded tolerance
        want = x.astype(np.float64) @ w.astype(np.float64)
        tol = coded_tol(ts, subsets[1], 8, want)
        assert_max_err(y_m, y_j, tol, "mesh vs reference threads")
        assert_max_err(y_m, want, tol, "mesh vs uncoded")

    def test_conv2d(self, name, fault, fp_kw, mesh_kw):
        rng = np.random.default_rng(12)
        x = rng.normal(size=(2, 3, 12, 26)).astype(np.float32)
        w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
        (y_t, y_m, y_j), subsets, ts = _run_three(
            name, fp_kw, mesh_kw,
            lambda s, ex: tcc.coded_conv2d(to_t(x), to_t(w), s,
                                           tsplit.ConvSpec(**CONV),
                                           executor=ex),
            lambda s, ex: jcc.coded_conv2d(to_j(x), to_j(w), s,
                                           jsplit.ConvSpec(**CONV),
                                           executor=ex))
        assert subsets[0] == subsets[1] == subsets[2]
        assert _bitwise(y_t, y_m)
        want = as_np(tcc.conv2d(to_t(x).double(), to_t(w).double(), 1))
        tol = coded_tol(ts, subsets[1], 27, want)
        assert_max_err(y_m, y_j, tol, "mesh vs reference threads")
        assert_max_err(y_m, want, tol, "mesh vs uncoded")


# ---------------------------------------------------------------------------
# the stacked kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t_p,b,F", [(10, 1, 48, 80), (10, 2, 300, 50),
                                       (10, 17, 48, 33), (3, 4, 8, 16)])
def test_stacked_piece_gemm_is_the_pieces_alone(n, t_p, b, F):
    """Each piece of the stack has the bits of its own skinny GEMM, and the
    reference's Pallas skinny GEMM (interpret mode) agrees per piece."""
    rng = np.random.default_rng(n * t_p + b)
    A = rounded(rng.normal(size=(n, t_p, b)) * b ** -0.5, "float32")
    X = rounded(rng.normal(size=(b, F)), "float32")
    got = piece_gemm_stacked(to_t(A), to_t(X))
    assert got.shape == (n, t_p, F)
    for i in range(n):
        assert torch.equal(got[i], skinny_gemm(to_t(A[i]), to_t(X)))
        want = skinny_gemm_pallas(to_j(A[i]), to_j(X), interpret=True)
        assert_scaled_close(got[i], want, np.abs(A[i]) @ np.abs(X),
                            sum_coef(b), f"piece {i} vs reference")


def test_stacked_wrappers_check_and_count_no_cpu_launch():
    g0 = piece_gemm_stacked.launches
    piece_gemm_stacked(torch.ones(2, 3, 4), torch.ones(4, 5))
    assert piece_gemm_stacked.launches == g0  # the plain version
    with pytest.raises(ValueError, match="pieces"):
        piece_gemm_stacked(torch.ones(3, 4), torch.ones(4, 5))
    with pytest.raises(ValueError, match="pieces"):
        conv2d_stacked(torch.ones(2, 3, 5, 5), torch.ones(1, 3, 3, 3))
    p = torch.randn(4, 2, 3, 6, 7, generator=torch.Generator().manual_seed(0))
    w = torch.randn(5, 3, 3, 3, generator=torch.Generator().manual_seed(1))
    got = conv2d_stacked(p, w, 1)
    for i in range(4):
        assert torch.equal(got[i], tcc.conv2d(p[i], w, 1))


# ---------------------------------------------------------------------------
# the seam and the MeshExecutor specifics
# ---------------------------------------------------------------------------

def _op(k, t_p, seed=0, d_in=8, d_out=16):
    rng = np.random.default_rng(seed)
    x = to_t(rng.normal(size=(k, t_p, d_in)))
    w = to_t(rng.normal(size=(d_in, d_out)))
    return x, w


def test_both_backends_satisfy_the_protocol():
    ex_t = tdist.CodedExecutor(3, clock=tdist.FakeClock(),
                               delay_model=tdist.DeterministicDelay(1.0))
    ex_m = tdist.MeshExecutor()
    try:
        assert isinstance(ex_t, ExecBackend)
        assert isinstance(ex_m, ExecBackend)
        assert ex_m.plan_matmul(None, "mds", 4, 8, 8) == (None, None, None)
        with ex_m.chain(2.5):
            assert ex_m._chain_t == 2.5
        assert ex_m._chain_t == 0.0
    finally:
        ex_t.close()
        ex_m.close()


def test_compile_once_per_shape():
    code = tschemes.get_scheme("mds").make(N, 3)
    xa, w = _op(code.k, 4)
    xb, _ = _op(code.k, 6, seed=1)
    with tdist.MeshExecutor() as ex:
        ya = ex.run_op(CodedOp("matmul", code, xa, w))
        assert torch.equal(ex.run_op(CodedOp("matmul", code, xa, w)), ya)
        assert ex.compile_count == 1  # same (scheme, shapes): cached
        ex.run_op(CodedOp("matmul", code, xb, w))
        assert ex.compile_count == 2  # new token count: one more build
        assert ex.run_count == 3
        assert ex.graph_count == 0 and ex.replay_count == 0  # CPU: eager
    assert_max_err(ya, torch.einsum("ktd,df->ktf", xa, w), 1e-4)


def test_placement_and_order_errors_are_typed():
    code = tschemes.get_scheme("mds").make(9, 3)  # 9 pieces > 8 lanes
    x, w = _op(3, 4, d_out=4)
    with tdist.MeshExecutor(make_local_mesh(model=8)) as ex:
        with pytest.raises(PiecePlacementError, match="extent"):
            ex.run_op(CodedOp("matmul", code, x, w))
    with pytest.raises(PiecePlacementError, match="no 'nope' axis"):
        tdist.MeshExecutor(axis="nope")
    with pytest.raises(PiecePlacementError, match="1 <= model"):
        make_local_mesh(model=0)
    mesh = make_local_mesh()
    assert mesh.shape == {"data": 1, "model": PIECE_LANES}
    assert PIECE_LANES >= 10  # the coded n this repository serves
    assert int(make_local_mesh(model=4).shape["model"]) == 4
    code = tschemes.get_scheme("mds").make(N, 3)
    with tdist.MeshExecutor(order=(0, 0, 1, 2, 3)) as ex:
        with pytest.raises(ValueError, match="permutation"):
            ex.run_op(CodedOp("matmul", code, x, w))
    with tdist.MeshExecutor(dead=(0, 1, 2)) as ex:  # mds(5, 3): 2 left
        ex.run_op(CodedOp("matmul", code, x, w))  # a dead piece re-runs
        assert ex.last_report.subset == [3, 4, 0]
        assert ex.last_report.redispatched == [(0, 0, 0)]


def test_thunk_surface_is_refused():
    with tdist.MeshExecutor() as ex:
        with pytest.raises(NotImplementedError, match="thunk"):
            ex.run(tschemes.get_scheme("mds").make(N, 3), [lambda: None])


def test_report_surface():
    code = tschemes.get_scheme("mds").make(N, 3)
    x, w = _op(code.k, 4, d_out=4)
    seen, sink = [], TraceRecorder()
    with tdist.MeshExecutor(dead=(1,)) as ex:
        ex.on_report = seen.append
        ex.trace_sink = sink
        ex.run_op(CodedOp("matmul", code, x, w))
        rep = ex.last_report
    assert seen == [rep]
    assert rep.wall_s > 0.0 and rep.t_complete == rep.wall_s
    assert all(isinstance(p, int) for p in rep.subset)
    assert rep.failures == [(1, 0.0)]
    assert 1 not in rep.subset  # mds(5,3) never needs the dead piece
    assert rep.subset == [0, 2, 3] and rep.cancelled == [4]
    assert rep.redispatched == []
    assert rep.assignment == {p: p for p in range(N)}
    # dispatch bookkeeping: n pieces, no redispatch consumed
    assert ex.pool.dispatch_count == code.n
    assert sorted(ex.pool.alive_workers()) == list(range(PIECE_LANES))
    (span,) = sink.spans
    assert (span.name, span.cat, span.tid) == ("run", "exec", "mesh")
    assert span.dur == rep.wall_s
    assert span.args == {"n": N, "k": 3, "pieces": N, "redispatches": 0,
                         "decoded": 3}


def test_dead_piece_is_redispatched_for_uncoded():
    code = tschemes.get_scheme("uncoded").make(4)
    x, w = _op(4, 3)
    with tdist.MeshExecutor(dead=(1,)) as ex:
        y = ex.run_op(CodedOp("matmul", code, x, w))
        rep = ex.last_report
    assert rep.subset == [0, 2, 3, 1]  # the dead piece arrives last
    assert rep.redispatched == [(1, 1, 1)]
    assert ex.pool.dispatch_count == 5
    assert_max_err(y, torch.einsum("ktd,df->ktf", x, w), 1e-4)


# ---------------------------------------------------------------------------
# the engine on the mesh backend
# ---------------------------------------------------------------------------

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def one_layer():
    """A one-layer Zamba2 smoke config (its shared attention + FFN block
    follows the layer), coded (4, 3), on the reference's parameters."""
    coded = dict(coded_n=4, coded_k=3, n_layers=1)
    jc = dataclasses.replace(jconfigs.smoke_config(ARCH), **coded)
    tc = dataclasses.replace(tconfigs.smoke_config(ARCH), **coded)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, tc.vocab, 6, dtype=np.int32),
                    max_new=3) for i in range(3)]
    return tc, tp, reqs


@pytest.mark.parametrize("fault,fp_kw,mesh_kw", FAULTS[1:],
                         ids=FAULT_IDS[1:])
def test_engine_token_parity_with_threads(one_layer, fault, fp_kw, mesh_kw):
    tc, tp, reqs = one_layer
    eng_m = Engine(tc, params=tp, executor=tdist.MeshExecutor(**mesh_kw),
                   device="cpu")
    ex = _threads(tdist, 4, fp_kw)
    try:
        out_t = Engine(tc, params=tp, executor=ex, device="cpu").generate(
            reqs)
        runs_t = ex.run_count
    finally:
        ex.close()
    out_m = eng_m.generate(reqs)
    assert eng_m.executor.run_count == runs_t > 0
    for a, b in zip(out_t, out_m):
        assert a.rid == b.rid
        assert a.tokens.tolist() == b.tokens.tolist()


def test_engine_string_shorthand_serves(one_layer):
    tc, tp, reqs = one_layer
    eng = Engine(tc, params=tp, executor="mesh", device="cpu")
    assert isinstance(eng.executor, tdist.MeshExecutor)
    plain = Engine(dataclasses.replace(tc, coded_n=0, coded_k=0), params=tp,
                   device="cpu").generate(reqs)
    out = eng.generate(reqs)
    assert eng.executor.run_count > 0 and eng.executor.compile_count >= 1
    for a, b in zip(plain, out):
        assert a.tokens.tolist() == b.tokens.tolist()


def test_engine_rejects_unknown_backend_string(one_layer):
    tc, tp, _ = one_layer
    with pytest.raises(ValueError, match="'mesh'"):
        Engine(tc, params=tp, executor="bogus", device="cpu")


def test_engine_rejects_segment_on_mesh(one_layer):
    tc, tp, _ = one_layer
    with pytest.raises(ValueError, match="threaded backend"):
        Engine(tc, params=tp, coded=(4, 2), scheme="replication",
               executor=tdist.MeshExecutor(), segment=True, device="cpu")


def test_engine_rejects_adaptive_on_mesh(one_layer):
    tc, tp, _ = one_layer
    with pytest.raises(ValueError, match="threaded pool backend"):
        Engine(tc, params=tp, executor=tdist.MeshExecutor(), adaptive=True,
               device="cpu")


def test_engine_rejects_non_f32_weights_on_mesh(one_layer):
    # the model casts a coded weight per call (w.float()); on the mesh that
    # would be a new graph key each call, so other types are refused
    tc, tp, _ = one_layer
    bad = dict(tp, embed=tp["embed"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="f32 weights"):
        Engine(tc, params=bad, executor=tdist.MeshExecutor(), device="cpu")
