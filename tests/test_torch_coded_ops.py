"""The coded pipelines of the port — ``coded_conv2d``, ``coded_matmul``,
``coded_ffn_segment``, ``run_segment`` — vs the JAX reference on the same
numpy inputs, and vs the port's own uncoded ``conv2d`` / ``@``.

Tolerances: a coded result carries the f32 roundoff of its pieces
(~sqrt(R) u for a length-R contraction) amplified by the decode of the
subset used (``decode_amp``: |D|_inf |G_S|_inf, 1 for the gathering
schemes), relative to the largest output.  Nothing here is bitwise: coded
vs uncoded, split vs whole and port vs reference all sum in other orders.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (U32, as_np, assert_max_err, coded_tol,
                           make_scheme, to_j, to_t)
from repro.core import coded_conv as jcc
from repro.core import coded_linear as jcl
from repro.core import schemes as jschemes
from repro.core import splitting as jsplit
from repro_torch.core import coded_conv as tcc
from repro_torch.core import coded_linear as tcl
from repro_torch.core import schemes as tschemes
from repro_torch.core import splitting as tsplit

NAMES = ["lt", "mds", "replication", "uncoded"]
NK = [(4, 2), (6, 4), (10, 6)]


_tol, _close = coded_tol, assert_max_err


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", NK)
@pytest.mark.parametrize("stride", [1, 2])
def test_coded_conv2d(name, n, k, stride):
    ts, js = make_scheme(tschemes, name, n, k), make_scheme(jschemes, name, n, k)
    kw = dict(c_in=3, c_out=5, h_in=9, w_in=27, kernel=3, stride=stride, batch=2)
    tspec, jspec = tsplit.ConvSpec(**kw), jsplit.ConvSpec(**kw)
    rng = np.random.default_rng(n * 10 + k + stride)
    x = rng.normal(size=(2, 3, 9, 27)).astype(np.float32)
    w = (rng.normal(size=(5, 3, 3, 3)) / 27 ** 0.5).astype(np.float32)
    plain_t = tcc.conv2d(to_t(x), to_t(w), stride)
    plain_j = jcc.conv2d(to_j(x), to_j(w), stride)
    # the port's conv (plain version here) vs the reference's conv
    _close(plain_t, plain_j, 64 * U32 * float(np.abs(as_np(plain_j)).max()),
           "uncoded conv")
    with tcc.boundary_op_counter() as t_ops:
        got = tcc.coded_conv2d(to_t(x), to_t(w), ts, tspec)
    with jcc.boundary_op_counter() as j_ops:
        want = jcc.coded_conv2d(to_j(x), to_j(w), js, jspec)
    assert t_ops == j_ops == {"encode": 1, "decode": 1}
    tol = _tol(ts, ts.default_subset(), 27, as_np(plain_j))
    _close(got, want, tol, "vs reference coded")
    _close(got, plain_t, tol, "vs own uncoded")
    # a non-default decodable subset, chosen from the far end
    sub = next(list(range(n - m, n)) for m in range(ts.min_done, ts.n + 1)
               if ts.decodable(list(range(n - m, n))))
    got2 = tcc.coded_conv2d(to_t(x), to_t(w), ts, tspec, subset=sub)
    want2 = jcc.coded_conv2d(to_j(x), to_j(w), js, jspec, subset=sub)
    tol2 = _tol(ts, sub, 27, as_np(plain_j))
    _close(got2, want2, tol2, "subset vs reference")
    _close(got2, plain_t, tol2, "subset vs own uncoded")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", NK)
@pytest.mark.parametrize("T", [23, 64])
def test_coded_matmul(name, n, k, T):
    """T = 23 is divisible by no k here: the master computes a remainder."""
    ts, js = make_scheme(tschemes, name, n, k), make_scheme(jschemes, name, n, k)
    rng = np.random.default_rng(T + n)
    x = rng.normal(size=(T, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 12)) / 4).astype(np.float32)
    want_plain = x.astype(np.float64) @ w.astype(np.float64)
    with tcc.boundary_op_counter() as t_ops:
        got = tcl.coded_matmul(to_t(x), to_t(w), ts)
    want = jcl.coded_matmul(to_j(x), to_j(w), js)
    assert t_ops == {"encode": 1, "decode": 1}
    tol = _tol(ts, ts.default_subset(), 16, want_plain)
    _close(got, want, tol, "vs reference coded")
    _close(got, to_t(x) @ to_t(w), tol, "vs own uncoded")
    assert tuple(got.shape) == (T, 12)


@pytest.mark.parametrize("name", ["replication", "uncoded"])
@pytest.mark.parametrize("gated", [False, True])
def test_coded_ffn_segment(name, gated):
    ts, js = make_scheme(tschemes, name, 6, 3), make_scheme(jschemes, name, 6, 3)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    w_in = (rng.normal(size=(8, 16)) / 3).astype(np.float32)
    w_out = (rng.normal(size=(16, 8)) / 4).astype(np.float32)
    w_gate = (rng.normal(size=(8, 16)) / 3).astype(np.float32) if gated else None
    import jax

    got = tcl.coded_ffn_segment(
        to_t(x), to_t(w_in), to_t(w_out), torch.nn.functional.silu, ts,
        w_gate=None if w_gate is None else to_t(w_gate))
    want = jcl.coded_ffn_segment(
        to_j(x), to_j(w_in), to_j(w_out), jax.nn.silu, js,
        w_gate=None if w_gate is None else to_j(w_gate))
    _close(got, want, 256 * U32 * float(np.abs(as_np(want)).max()), "ffn")


@pytest.mark.parametrize("name", ["mds", "lt"])
def test_linear_mix_rejections_raise_the_same_errors(name):
    ts, js = make_scheme(tschemes, name, 6, 3), make_scheme(jschemes, name, 6, 3)
    x, w = torch.ones(6, 4), torch.ones(4, 4)
    with pytest.raises(ValueError) as t_err:
        tcl.coded_ffn_segment(x, w, w, torch.relu, ts)
    with pytest.raises(ValueError) as j_err:
        jcl.coded_ffn_segment(to_j(x.numpy()), to_j(w.numpy()), to_j(w.numpy()),
                              lambda a: a, js)
    assert str(t_err.value) == str(j_err.value)

    kw = dict(c_in=2, c_out=2, h_in=12, w_in=12, kernel=3, stride=1)
    for acts, pads in ((["relu", None], [1, 0]), ([None, None], [1, 1])):
        tspecs = [tsplit.ConvSpec(**kw), tsplit.ConvSpec(
            **{**kw, "h_in": 10 + 2 * pads[1], "w_in": 10 + 2 * pads[1]})]
        jspecs = [jsplit.ConvSpec(**kw), jsplit.ConvSpec(
            **{**kw, "h_in": 10 + 2 * pads[1], "w_in": 10 + 2 * pads[1]})]
        xs = np.ones((1, 2, 12, 12), np.float32)
        ws = [np.ones((2, 2, 3, 3), np.float32)] * 2
        with pytest.raises(ValueError) as t_err:
            tcc.run_segment(to_t(xs), [to_t(v) for v in ws], ts, tspecs,
                            pads, acts)
        with pytest.raises(ValueError) as j_err:
            jcc.run_segment(to_j(xs), [to_j(v) for v in ws], js, jspecs,
                            pads, acts)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="inconsistent segment arity"):
        tcc.run_segment(to_t(xs), [to_t(ws[0])], ts, tspecs, pads, acts)


def _relu_chain(mod, depth, size, c=6):
    specs, pads, acts, s = [], [], [], size
    for j in range(depth):
        specs.append(mod.ConvSpec(c_in=3 if j == 0 else c, c_out=c,
                                  h_in=s + 2, w_in=s + 2, kernel=3, stride=1))
        pads.append(1)
        acts.append("relu")
        s = specs[-1].w_out
    return specs, pads, acts


@pytest.mark.parametrize("name,n", [("replication", 6), ("replication", 4),
                                    ("uncoded", 3)])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("chunks", [None, 3])
def test_run_segment_with_interior_relu(name, n, depth, chunks):
    """Selection schemes keep pieces resident across interior activations
    and re-pads; the result equals the layer-by-layer chain."""
    ts, js = make_scheme(tschemes, name, n, 0), make_scheme(jschemes, name, n, 0)
    tspecs, pads, acts = _relu_chain(tsplit, depth, 20)
    jspecs, _, _ = _relu_chain(jsplit, depth, 20)
    rng = np.random.default_rng(depth * 7 + n)
    x = rng.normal(size=(2, 3, 22, 22)).astype(np.float32)
    ws = [(rng.normal(size=(s.c_out, s.c_in, 3, 3))
           * (s.c_in * 9) ** -0.5).astype(np.float32) for s in tspecs]
    with tcc.boundary_op_counter() as t_ops:
        got = tcc.run_segment(to_t(x), [to_t(w) for w in ws], ts, tspecs,
                              pads, acts, stream_chunks=chunks)
    with jcc.boundary_op_counter() as j_ops:
        want = jcc.run_segment(to_j(x), [to_j(w) for w in ws], js, jspecs,
                               pads, acts, stream_chunks=chunks)
    assert t_ops == j_ops == {"encode": 1, "decode": 1}
    h = to_t(x)
    for j, (w, sp) in enumerate(zip(ws, tspecs)):
        if j > 0:
            h = torch.nn.functional.pad(torch.relu(h), (1, 1, 1, 1))
        h = tcc.conv2d(h, to_t(w), sp.stride)
    tol = 256 * U32 * float(h.abs().max())
    _close(got, want, tol, "segment vs reference")
    _close(got, h, tol, "segment vs layer by layer")


@pytest.mark.parametrize("name", ["mds", "lt"])
@pytest.mark.parametrize("chunks", [None, 2])
def test_run_segment_linear_chain_under_linear_mixes(name, chunks):
    """No interior activation, no re-pad: a linear mix may fuse two layers."""
    ts, js = make_scheme(tschemes, name, 6, 3), make_scheme(jschemes, name, 6, 3)
    def chain(mod):
        a = mod.ConvSpec(c_in=3, c_out=4, h_in=20, w_in=20, kernel=3, stride=1)
        b = mod.ConvSpec(c_in=4, c_out=4, h_in=18, w_in=18, kernel=3, stride=1)
        return [a, b]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, 20, 20)).astype(np.float32)
    ws = [(rng.normal(size=(4, 3, 3, 3)) / 27 ** .5).astype(np.float32),
          (rng.normal(size=(4, 4, 3, 3)) / 6).astype(np.float32)]
    got = tcc.run_segment(to_t(x), [to_t(w) for w in ws], ts, chain(tsplit),
                          [0, 0], [None, None], stream_chunks=chunks)
    want = jcc.run_segment(to_j(x), [to_j(w) for w in ws], js, chain(jsplit),
                           [0, 0], [None, None], stream_chunks=chunks)
    h = tcc.conv2d(tcc.conv2d(to_t(x), to_t(ws[0])), to_t(ws[1]))
    tol = _tol(ts, ts.default_subset(), 36 * 27, as_np(h))
    _close(got, want, tol, "vs reference")
    _close(got, h, tol, "vs layer by layer")


@pytest.mark.parametrize("name", ["gelu", "silu", "relu"])
def test_activations_match_reference(name):
    """gelu is the tanh approximation on both sides."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tcc.ACTIVATIONS[name](to_t(x))
    want = jcc.ACTIVATIONS[name](to_j(x))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
def test_conv2d_chunked_and_split_input(chunks):
    rng = np.random.default_rng(chunks)
    x = to_t(rng.normal(size=(2, 3, 8, 19)))
    w = to_t(rng.normal(size=(4, 3, 3, 3)))
    whole = tcc.conv2d(x, w, 2)
    got = tcc.conv2d_chunked(x, w, 2, chunks)
    want = jcc.conv2d_chunked(to_j(x.numpy()), to_j(w.numpy()), 2, chunks)
    tol = 64 * U32 * float(whole.abs().max())
    _close(got, whole, tol, "chunked vs whole")
    _close(got, want, tol, "chunked vs reference")
    kw = dict(c_in=3, c_out=4, h_in=8, w_in=19, kernel=3, stride=2, batch=2)
    tp = tsplit.plan_width_split(tsplit.ConvSpec(**kw), 3)
    jp = jsplit.plan_width_split(jsplit.ConvSpec(**kw), 3)
    assert np.array_equal(as_np(tcc.split_input(x, tp)),
                          as_np(jcc.split_input(to_j(x.numpy()), jp)))
