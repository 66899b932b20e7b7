"""Modules the port copied from the reference (they import no JAX): exact
equality with ``repro`` over a grid of inputs, which also guards the copies
against drift.  Results are compared as plain nested python, because the
two packages' dataclasses are distinct classes.
"""
import numpy as np
import pytest

from _torch_parity import plain
from repro.core import hetero as jhetero
from repro.core import latency as jlat
from repro.core import netplan as jnet
from repro.core import planner as jplan
from repro.core import splitting as jsplit
from repro.dist import clock as jclock
from repro.dist import faults as jfaults
from repro.models import cnn as jcnn
from repro_torch.core import hetero as thetero
from repro_torch.core import latency as tlat
from repro_torch.core import netplan as tnet
from repro_torch.core import planner as tplan
from repro_torch.core import splitting as tsplit
from repro_torch.dist import clock as tclock
from repro_torch.dist import faults as tfaults
from repro_torch.models import cnn as tcnn

SPECS = [  # (c_in, c_out, h_in, w_in, kernel, stride)
    (3, 8, 12, 12, 3, 1), (16, 32, 14, 20, 3, 1), (8, 7, 11, 17, 5, 2),
    (4, 64, 9, 9, 1, 1), (32, 16, 8, 30, 3, 2), (128, 128, 114, 114, 3, 1),
    (512, 512, 16, 16, 3, 1), (3, 64, 70, 70, 7, 2),
]


def _spec(mod, s, batch=1):
    return mod.ConvSpec(c_in=s[0], c_out=s[1], h_in=s[2], w_in=s[3],
                        kernel=s[4], stride=s[5], batch=batch)


def _params(mod, i):
    if i == 0:
        return mod.SystemParams()
    return mod.SystemParams(mu_m=2.5e9, theta_m=4e-10, mu_cmp=4e9,
                            theta_cmp=1.35e-9, mu_rec=1.5e7, theta_rec=3e-7,
                            mu_sen=1.5e7, theta_sen=3e-7)


# -- core/splitting.py -------------------------------------------------------

@pytest.mark.parametrize("s", SPECS)
def test_plan_width_split(s):
    jt, tt = _spec(jsplit, s, 2), _spec(tsplit, s, 2)
    assert plain(jt) == plain(tt)
    for attr in ("h_out", "w_out"):
        assert getattr(jt, attr) == getattr(tt, attr)
    for k in range(1, min(jt.w_out, 12) + 1):
        assert plain(tsplit.plan_width_split(tt, k)) == \
            plain(jsplit.plan_width_split(jt, k)), k
        assert tt.subtask_flops(k) == jt.subtask_flops(k)
        assert tt.recv_bytes(k) == jt.recv_bytes(k)
        assert tt.send_bytes(k) == jt.send_bytes(k)
    with pytest.raises(ValueError):
        tsplit.plan_width_split(tt, tt.w_out + 1)


@pytest.mark.parametrize("T", [1, 7, 64, 1030, 4097])
def test_plan_token_split(T):
    for k in (1, 2, 3, 6, 7, 16):
        if k > T:
            continue
        assert plain(tsplit.plan_token_split(T, k)) == \
            plain(jsplit.plan_token_split(T, k))


CHAINS = [  # ([spec...], pads)
    ([(3, 8, 34, 34, 3, 1), (8, 8, 34, 34, 3, 1)], [1, 1]),
    ([(3, 8, 34, 34, 3, 1), (8, 8, 34, 34, 3, 1), (8, 4, 34, 34, 3, 2)],
     [1, 1, 1]),
    ([(4, 4, 20, 20, 3, 1), (4, 4, 18, 18, 3, 1)], [0, 0]),
    ([(4, 4, 21, 21, 5, 2), (4, 6, 11, 11, 3, 1)], [2, 1]),
]


@pytest.mark.parametrize("chain", range(len(CHAINS)))
def test_plan_segment_split(chain):
    specs, pads = CHAINS[chain]
    js = [_spec(jsplit, s) for s in specs]
    ts = [_spec(tsplit, s) for s in specs]
    for k in (1, 2, 3, 4, 5):
        assert plain(tsplit.plan_segment_split(ts, pads, k)) == \
            plain(jsplit.plan_segment_split(js, pads, k)), k
    w = ts[-1].w_out
    assert plain(tsplit.chain_steps(ts, pads, 1, w - 1)) == \
        plain(jsplit.chain_steps(js, pads, 1, w - 1))


# -- core/latency.py ---------------------------------------------------------

@pytest.mark.parametrize("s", SPECS)
def test_phase_sizes(s):
    jt, tt = _spec(jsplit, s), _spec(tsplit, s)
    for n in (4, 10):
        for k in range(1, min(n, jt.w_out) + 1):
            assert plain(tlat.phase_sizes(tt, n, k)) == \
                plain(jlat.phase_sizes(jt, n, k))
            assert plain(tlat.sizes_for_width(tt, n, k, 1)) == \
                plain(jlat.sizes_for_width(jt, n, k, 1))


def test_latency_primitives():
    for n in (1, 2, 10, 100):
        assert tlat.harmonic(n) == jlat.harmonic(n)
    for stages in ((1.0, 2.0, 0.5), (0.1, 5.0, 0.1), (3.0,)):
        assert tlat.stream_chunk_count(stages) == jlat.stream_chunk_count(stages)
        for c in (1, 2, 4, 8):
            assert tlat.pipelined_time(stages, c) == jlat.pipelined_time(stages, c)
    for n, k in ((5, 3), (10, 6), (10, 10)):
        assert tlat.exp_order_stat_mean(n, k, 2.5) == \
            jlat.exp_order_stat_mean(n, k, 2.5)
    a = tlat.ShiftExp(2e8, 2e-9).scaled(1e6)
    b = jlat.ShiftExp(2e8, 2e-9).scaled(1e6)
    assert (a.shift, a.rate, a.mean()) == (b.shift, b.rate, b.mean())
    assert a.order_stat_mean(10, 6) == b.order_stat_mean(10, 6)
    assert np.array_equal(a.sample(np.random.default_rng(3), (4, 5)),
                          b.sample(np.random.default_rng(3), (4, 5)))
    t = np.linspace(0, 0.05, 7)
    assert np.array_equal(a.cdf(t), b.cdf(t))
    assert plain(tlat.SystemParams().scaled_tr(3.0)) == \
        plain(jlat.SystemParams().scaled_tr(3.0))


# -- core/planner.py, core/hetero.py -----------------------------------------

@pytest.mark.parametrize("s", SPECS)
@pytest.mark.parametrize("pi", [0, 1])
def test_k_circ(s, pi):
    jt, tt = _spec(jsplit, s), _spec(tsplit, s)
    jp, tp = _params(jlat, pi), _params(tlat, pi)
    for n in (4, 10, 16):
        assert tplan.k_circ(tt, n, tp) == jplan.k_circ(jt, n, jp)
        assert tplan.k_circ_remainder_aware(tt, n, tp) == \
            jplan.k_circ_remainder_aware(jt, n, jp)
        for scheme in ("mds", "replication", "uncoded", "lt"):
            assert tplan.plan_k(scheme, tt, n, tp) == \
                jplan.plan_k(scheme, jt, n, jp)
        k = min(3, jt.w_out)
        assert tplan.L(tt, n, k, tp) == jplan.L(jt, n, k, jp)
        assert tplan.L_continuous(tt, n, 2.5, tp) == \
            jplan.L_continuous(jt, n, 2.5, jp)
    assert tplan.straggling_index_R(tt, tp) == jplan.straggling_index_R(jt, jp)
    assert plain(tplan.plan_layer(tt, 10, tp)) == plain(jplan.plan_layer(jt, 10, jp))


def test_monte_carlo_planners_same_seed_same_numbers():
    s = SPECS[1]
    jt, tt = _spec(jsplit, s), _spec(tsplit, s)
    jp, tp = jlat.SystemParams(), tlat.SystemParams()
    assert tplan.expected_latency_mc(tt, 6, 3, tp, samples=500) == \
        jplan.expected_latency_mc(jt, 6, 3, jp, samples=500)
    assert tplan.k_star(tt, 6, tp, samples=300) == \
        jplan.k_star(jt, 6, jp, samples=300)
    assert tplan.uncoded_latency(tt, 6, tp) == jplan.uncoded_latency(jt, 6, jp)
    assert tplan.uncoded_latency_mc(tt, 6, tp, samples=300) == \
        jplan.uncoded_latency_mc(jt, 6, jp, samples=300)
    assert tplan.replication_latency_mc(tt, 6, tp, samples=300) == \
        jplan.replication_latency_mc(jt, 6, jp, samples=300)


@pytest.mark.parametrize("speeds", [
    [1.0] * 4, [1.0, 2.0, 4.0], [0.1, 5.0, 5.0, 5.0, 0.1], [3.0], [1, 1, 1, 7],
])
def test_allocate_pieces(speeds):
    for n_pieces in (1, 4, 10, 17):
        assert thetero.allocate_pieces(speeds, n_pieces) == \
            jhetero.allocate_pieces(speeds, n_pieces)
    assert thetero.worker_speed(tlat.SystemParams()) == \
        jhetero.worker_speed(jlat.SystemParams())


def test_simulate_hetero_same_seed_same_latency():
    s = SPECS[1]
    a = thetero.simulate_hetero(
        _spec(tsplit, s), 3, [2, 1, 2],
        [tlat.SystemParams()] * 3, np.random.default_rng(5))
    b = jhetero.simulate_hetero(
        _spec(jsplit, s), 3, [2, 1, 2],
        [jlat.SystemParams()] * 3, np.random.default_rng(5))
    assert a == b


# -- core/netplan.py + the models' layer lists -------------------------------

def _nets(cnn, lat):
    return {
        "small_cnn": (cnn.small_cnn_layers(32), cnn.SMALL_CNN_PARAMS, 6),
        "vgg16_224": (cnn.vgg16_conv_specs(224), lat.SystemParams(), 10),
        "vgg16_32": (cnn.vgg16_conv_specs(32), lat.SystemParams(), 10),
        "resnet18_64": (cnn.resnet18_conv_specs(64), lat.SystemParams(), 10),
    }


@pytest.mark.parametrize("net", ["small_cnn", "vgg16_224", "vgg16_32",
                                 "resnet18_64"])
@pytest.mark.parametrize("scheme", ["mds", "replication", "uncoded", "lt"])
def test_compile_plan(net, scheme):
    jl, jp, n = _nets(jcnn, jlat)[net]
    tl, tp, _ = _nets(tcnn, tlat)[net]
    assert plain(tl) == plain(jl)
    assert tcnn.cnn_head_features(tl) == jcnn.cnn_head_features(jl)
    jplan_, tplan_ = (jnet.compile_plan(jl, n, jp, scheme),
                      tnet.compile_plan(tl, n, tp, scheme))
    assert tplan_.describe() == jplan_.describe()
    assert tplan_.boundary_coding_ops == jplan_.boundary_coding_ops
    assert tplan_.n_segments == jplan_.n_segments
    assert tplan_.master_worker_bytes == jplan_.master_worker_bytes
    assert tplan_.est_latency_s == jplan_.est_latency_s
    assert plain(tplan_.steps) == plain(jplan_.steps)
    per_t = tnet.compile_plan(tl, n, tp, scheme, max_depth=1)
    per_j = jnet.compile_plan(jl, n, jp, scheme, max_depth=1)
    assert per_t.describe() == per_j.describe()


def test_vgg16_main_path_plan_is_what_the_smoke_run_assumes():
    """VGG16 at 224 under mds, n=10: three local layers, then ten depth-1
    (10, 6) segments, each with a master remainder."""
    plan = tnet.compile_plan(tcnn.vgg16_conv_specs(224), 10,
                             tlat.SystemParams(), "mds")
    assert [type(s).__name__ for s in plan.steps] == \
        ["LocalStep"] * 3 + ["SegmentStep"] * 10
    for seg in plan.segments:
        assert (seg.n, seg.k, seg.depth) == (10, 6, 1)
        assert seg.split.remainder is not None
    first = plan.segments[0].split.parts[0].entry
    assert (first.a_i, first.b_i) == (0, 20)


def test_type1_classification_and_segment_sizes():
    assert tcnn.type1_threshold() == jcnn.type1_threshold()
    for tl, jl in zip(tcnn.resnet18_conv_specs(224), jcnn.resnet18_conv_specs(224)):
        assert tl.type1 == jl.type1 and tl.name == jl.name
        assert tcnn.is_type1(tl.spec) == jcnn.is_type1(jl.spec)
    specs, pads = CHAINS[0]
    ts, js = [_spec(tsplit, s) for s in specs], [_spec(jsplit, s) for s in specs]
    from repro.core.schemes import ReplicationScheme as JRep
    from repro_torch.core.schemes import ReplicationScheme as TRep
    assert plain(tnet.segment_layer_sizes(ts, pads, TRep(6))) == \
        plain(jnet.segment_layer_sizes(js, pads, JRep(6)))
    assert tnet.segment_latency(ts, pads, TRep(6), tlat.SystemParams()) == \
        jnet.segment_latency(js, pads, JRep(6), jlat.SystemParams())
    assert plain(tnet.segment_sizes(ts, pads, TRep(6))) == \
        plain(jnet.segment_sizes(js, pads, JRep(6)))
    for name in ("mds", "replication", "uncoded", "lt"):
        assert tnet.order_factor(name, 10, 6) == jnet.order_factor(name, 10, 6)


# -- dist/clock.py, dist/faults.py -------------------------------------------

def test_fault_plan_and_delay_timelines():
    kw = dict(dead=frozenset({1}), straggler={2: 50.0}, fail_at_piece={3: 2})
    tf, jf = tfaults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    for w in range(6):
        assert tf.slowdown(w) == jf.slowdown(w)
        assert tf.fails_at(w) == jf.fails_at(w)
    for table in (1.0, 0.25, [1.0, 2.0, 4.0]):
        td, jd = tfaults.DeterministicDelay(table), jfaults.DeterministicDelay(table)
        assert [td.piece_time(w, p) for w in range(7) for p in range(3)] == \
            [jd.piece_time(w, p) for w in range(7) for p in range(3)]
    drift_t = tfaults.StragglerDrift(((0, tfaults.FaultPlan()), (3, tf)))
    drift_j = jfaults.StragglerDrift(((0, jfaults.FaultPlan()), (3, jf)))
    for i in range(6):
        assert plain(drift_t.plan_at(i)) == plain(drift_j.plan_at(i))
    with pytest.raises(ValueError):
        tfaults.StragglerDrift(((3, tf), (0, tf)))


@pytest.mark.parametrize("chunks", [1, 3])
def test_shift_exp_and_segment_delays(chunks):
    s = SPECS[1]
    tsz = tlat.phase_sizes(_spec(tsplit, s), 6, 3)
    jsz = jlat.phase_sizes(_spec(jsplit, s), 6, 3)
    td = tfaults.ShiftExpDelay(tlat.SystemParams(), tsz, seed=4, chunks=chunks)
    jd = jfaults.ShiftExpDelay(jlat.SystemParams(), jsz, seed=4, chunks=chunks)
    for w in range(4):
        for p in range(3):
            assert td.piece_time(w, p) == jd.piece_time(w, p)
            assert td.stage_times(w, p) == jd.stage_times(w, p)
    tseg = tfaults.SegmentDelay(tlat.SystemParams(), (tsz, tsz), chunks=chunks)
    jseg = jfaults.SegmentDelay(jlat.SystemParams(), (jsz, jsz), chunks=chunks)
    for w in range(3):
        assert tseg.piece_time(w, 0) == jseg.piece_time(w, 0)
        assert tseg.stage_times(w, 0) == jseg.stage_times(w, 0)
    assert plain(tfaults.per_layer_sizes((tsz, tsz))) == \
        plain(jfaults.per_layer_sizes((jsz, jsz)))


def test_churn_schedules_and_clock():
    for make in (lambda m: m.ChurnSchedule.flash_crowd(2.0, 3),
                 lambda m: m.ChurnSchedule.rolling_restart(
                     [0, 1, 2], 1.0, down_s=0.5, stagger_s=2.0),
                 lambda m: m.ChurnSchedule.departures([1, 3], [0.5, 2.5])):
        assert plain(make(tfaults)) == plain(make(jfaults))
        assert plain(make(tfaults).until(1.5)) == plain(make(jfaults).until(1.5))
    tc, jc = tclock.FakeClock(), jclock.FakeClock()
    for c in (tc, jc):
        c.advance(1.5)
        c.advance(0.5)
    assert tc.now() == jc.now() and tc.virtual and jc.virtual
    assert not tclock.RealClock().virtual
    assert tclock.pipelined_time is tlat.pipelined_time
