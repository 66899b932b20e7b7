"""The slice as a whole: the CNN forwards of the port vs the JAX reference.

Parameters are made by the reference's own ``init_*`` functions, passed
through numpy and ``repro_torch.convert``; the input is numpy from a seed.
Both packages then run the same network — locally, through the compiled
segment plan, and on a worker pool with a dead worker and a straggler.

Tolerance: f32 throughout; logits may differ by ``TOL * max|logit|``.  TOL
covers the roundoff of the stack (other summation orders in the two conv
implementations) and, for the linear-mix schemes, its amplification by one
decode per segment; the measured differences sit an order of magnitude
below it.  The predicted class must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import as_np, to_j, to_t
from repro import dist as jdist
from repro.core.coded_conv import boundary_op_counter as j_counter
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.core.coded_conv import boundary_op_counter as t_counter
from repro_torch.models import cnn as tcnn

SCHEMES = ["mds", "replication", "uncoded", "lt"]
TOL = {"mds": 2e-3, "lt": 2e-3, "replication": 1e-4, "uncoded": 1e-4,
       None: 1e-4}


def _params(init, image, seed=0, **kw):
    ref = init(jax.random.PRNGKey(seed), image=image, **kw)
    as_numpy = {"convs": [np.asarray(w) for w in ref["convs"]],
                "head": np.asarray(ref["head"])}
    return ref, convert.cnn_params_from_numpy(as_numpy, device="cpu")


def _input(image, batch=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(batch, 3, image, image)).astype(np.float32)


def _check(got, want, scheme, what):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    lim = TOL[scheme] * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: err {err:.3g} > {lim:.3g}"
    assert (got.argmax(-1) == want.argmax(-1)).all(), what


def _executor(mod, n):
    return mod.CodedExecutor(
        n, clock=mod.FakeClock(), delay_model=mod.DeterministicDelay(1.0),
        fault_plan=mod.FaultPlan(dead=frozenset({1}), straggler={2: 50.0}))


# -- small CNN ---------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ref, port = _params(jcnn.init_small_cnn, 32)
    x = _input(32)
    return ref, port, x, jcnn.small_cnn_forward(ref, to_j(x))


def test_small_cnn_local(small):
    ref, port, x, want = small
    _check(tcnn.small_cnn_forward(port, to_t(x)), want, None, "local")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_small_cnn_functional(small, scheme):
    ref, port, x, want_local = small
    with j_counter() as j_ops:
        want = jcnn.small_cnn_forward(ref, to_j(x), scheme=scheme, n=6)
    with t_counter() as t_ops:
        got = tcnn.small_cnn_forward(port, to_t(x), scheme=scheme, n=6)
    assert t_ops == j_ops and t_ops["encode"] >= 1
    _check(got, want, scheme, "vs reference coded")
    # coded on == coded off, within the port
    _check(got, tcnn.small_cnn_forward(port, to_t(x)), scheme, "vs local")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_small_cnn_on_the_pool(small, scheme):
    ref, port, x, want_local = small
    tex, jex = _executor(tdist, 6), _executor(jdist, 6)
    try:
        want = jcnn.small_cnn_forward(ref, to_j(x), scheme=scheme, n=6,
                                      executor=jex)
        got = tcnn.small_cnn_forward(port, to_t(x), scheme=scheme, n=6,
                                     executor=tex)
        assert tex.run_count == jex.run_count >= 1
        assert tex.pool.dispatch_count == jex.pool.dispatch_count
        assert tex.last_report.subset == jex.last_report.subset
        assert tex.last_report.t_complete == jex.last_report.t_complete
        _check(got, want, scheme, "pool vs reference pool")
        _check(got, tcnn.small_cnn_forward(port, to_t(x)), scheme,
               "pool vs local")
    finally:
        tex.close()
        jex.close()


def test_small_cnn_pinned_code_and_precompiled_plan(small):
    """The compatibility entry (``code=`` pins one instance for every
    segment) and the serving entry (``plan=`` compiled once)."""
    from repro.core import schemes as jschemes
    from repro.core.netplan import compile_plan as j_compile
    from repro_torch.core import schemes as tschemes
    from repro_torch.core.netplan import compile_plan as t_compile

    ref, port, x, _ = small
    want = jcnn.small_cnn_forward(ref, to_j(x), jschemes.MDSScheme(5, 3),
                                  subset=[4, 2, 0])
    got = tcnn.small_cnn_forward(port, to_t(x), tschemes.MDSScheme(5, 3),
                                 subset=[4, 2, 0])
    _check(got, want, "mds", "pinned code, chosen subset")
    jp = j_compile(jcnn.small_cnn_layers(32), 6, jcnn.SMALL_CNN_PARAMS,
                   "replication")
    tp = t_compile(tcnn.small_cnn_layers(32), 6, tcnn.SMALL_CNN_PARAMS,
                   "replication")
    assert tp.describe() == jp.describe()
    _check(tcnn.small_cnn_forward(port, to_t(x), plan=tp),
           jcnn.small_cnn_forward(ref, to_j(x), plan=jp), "replication",
           "precompiled plan")
    with pytest.raises(ValueError, match="needs n="):
        tcnn.small_cnn_forward(port, to_t(x), scheme="mds")


# -- VGG16 at image 32 -------------------------------------------------------

@pytest.fixture(scope="module")
def vgg():
    ref, port = _params(jcnn.init_vgg16, 32)
    x = _input(32, seed=2)
    return ref, port, x, jcnn.vgg16_forward(ref, to_j(x))


def test_vgg16_local(vgg):
    ref, port, x, want = vgg
    _check(tcnn.vgg16_forward(port, to_t(x)), want, None, "local")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_vgg16_functional(vgg, scheme):
    ref, port, x, want_local = vgg
    with j_counter() as j_ops:
        want = jcnn.vgg16_forward(ref, to_j(x), scheme=scheme, n=10)
    with t_counter() as t_ops:
        got = tcnn.vgg16_forward(port, to_t(x), scheme=scheme, n=10)
    assert t_ops == j_ops and t_ops["encode"] == t_ops["decode"] >= 9
    _check(got, want, scheme, "vs reference coded")
    _check(got, tcnn.vgg16_forward(port, to_t(x)), scheme, "vs local")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_vgg16_on_the_pool(vgg, scheme):
    ref, port, x, want_local = vgg
    tex, jex = _executor(tdist, 10), _executor(jdist, 10)
    try:
        want = jcnn.vgg16_forward(ref, to_j(x), scheme=scheme, n=10,
                                  executor=jex)
        got = tcnn.vgg16_forward(port, to_t(x), scheme=scheme, n=10,
                                 executor=tex)
        assert tex.run_count == jex.run_count >= 9
        assert tex.pool.dispatch_count == jex.pool.dispatch_count
        assert tex.last_report.subset == jex.last_report.subset
        _check(got, want, scheme, "pool vs reference pool")
        _check(got, tcnn.vgg16_forward(port, to_t(x)), scheme, "pool vs local")
    finally:
        tex.close()
        jex.close()


# -- ResNet18 at image 64 ----------------------------------------------------

@pytest.fixture(scope="module")
def resnet():
    ref, port = _params(jcnn.init_resnet18, 64)
    x = _input(64, batch=1, seed=3)
    return ref, port, x, jcnn.resnet18_forward(ref, to_j(x))


def test_resnet18_local(resnet):
    ref, port, x, want = resnet
    _check(tcnn.resnet18_forward(port, to_t(x)), want, None, "local")


@pytest.mark.parametrize("scheme", ["mds", "replication"])
def test_resnet18_functional(resnet, scheme):
    ref, port, x, want_local = resnet
    want = jcnn.resnet18_forward(ref, to_j(x), scheme=scheme, n=6)
    got = tcnn.resnet18_forward(port, to_t(x), scheme=scheme, n=6)
    _check(got, want, scheme, "vs reference coded")
    _check(got, tcnn.resnet18_forward(port, to_t(x)), scheme, "vs local")


def test_resnet18_on_the_pool(resnet):
    ref, port, x, want_local = resnet
    tex = _executor(tdist, 6)
    try:
        got = tcnn.resnet18_forward(port, to_t(x), scheme="replication", n=6,
                                    executor=tex)
        assert tex.run_count >= 8
        _check(got, want_local, "replication", "pool vs reference local")
    finally:
        tex.close()


# -- parameters across, and the port's own init ------------------------------

def test_convert_roundtrip_is_exact():
    ref, port = _params(jcnn.init_small_cnn, 32, seed=5)
    back = convert.cnn_params_to_numpy(port)
    for a, b in zip(back["convs"], ref["convs"]):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    assert np.array_equal(back["head"], np.asarray(ref["head"]))
    bf = convert.cnn_params_from_numpy(back, device="cpu",
                                       dtype=torch.bfloat16)
    assert bf["head"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        convert.cnn_params_from_numpy(
            {"convs": [np.zeros((2, 2, 3))], "head": np.zeros((2, 2))},
            device="cpu")


@pytest.mark.parametrize("net", ["small", "vgg16", "resnet18"])
def test_init_is_seeded_and_shaped_like_the_reference(net):
    t_init, j_init, image = {
        "small": (tcnn.init_small_cnn, jcnn.init_small_cnn, 32),
        "vgg16": (tcnn.init_vgg16, jcnn.init_vgg16, 32),
        "resnet18": (tcnn.init_resnet18, jcnn.init_resnet18, 64)}[net]
    a = t_init(torch.Generator().manual_seed(3), image=image, device="cpu")
    b = t_init(torch.Generator().manual_seed(3), image=image, device="cpu")
    ref = j_init(jax.random.PRNGKey(3), image=image)
    assert [tuple(w.shape) for w in a["convs"]] == \
        [tuple(w.shape) for w in ref["convs"]]
    assert tuple(a["head"].shape) == tuple(ref["head"].shape)
    assert all(torch.equal(x, y) for x, y in zip(a["convs"], b["convs"]))
    # He init: the spread of a wide layer follows sqrt(2 / fan_in)
    w = a["convs"][-1]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) / (2.0 / fan_in) ** 0.5 - 1.0) < 0.05


def test_maxpool_matches_reference():
    x = np.random.default_rng(0).normal(size=(2, 3, 9, 11)).astype(np.float32)
    for window, stride in ((2, None), (3, 2), (2, 1)):
        assert np.array_equal(
            as_np(tcnn.maxpool2d(to_t(x), window, stride)),
            as_np(jcnn.maxpool2d(to_j(x), window, stride)))
