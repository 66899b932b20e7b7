"""The sharded coded forms of the port — ``coded_matmul_sharded`` and
``coded_conv2d_sharded`` — on ``torch.distributed``: four processes in a
gloo group (rendezvous through a ``FileStore`` in a temporary directory),
one coded piece per rank of a (data=1, model=4) ``DeviceMesh``.

The reference's sharded forms raise ``ShardingTypeError`` on jax 0.9.0 at
their subset gather, so their stand-ins are the reference's functional
forms with ``subset=code.default_subset()``: the subset the sharded forms
decode.  Tolerance (``coded_tol``): the pieces' f32 roundoff for a
length-R contraction, amplified by the decode of that subset, relative to
the largest output.  Every rank returns the same bits.

The four ranks run once for every case (a module fixture); their join is
bounded by 60 s, so a hung rendezvous fails the tests instead of the run.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

import _torch_sharded_worker
from _torch_parity import as_np, assert_max_err, coded_tol, make_scheme, to_j
from repro.core import coded_conv as jcc
from repro.core import coded_linear as jcl
from repro.core import schemes as jschemes
from repro.core import splitting as jsplit
from repro_torch.core import coded_conv as tcc
from repro_torch.core import coded_linear as tcl
from repro_torch.core import schemes as tschemes

WORLD = 4
K = 3                              # replication and uncoded fix their own k
NAMES = tschemes.scheme_names()
T, D_IN, D_OUT = 26, 16, 12        # 26 = 3 * 8 + 2: a master remainder
CONV = (4, 6, 8, 12, 3, 1, 2)      # c_in, c_out, h_in, w_in, kernel, stride, batch
JOIN_S = 60.0


def _inputs() -> dict:
    rng = np.random.default_rng(25)
    c_in, c_out, h, w, kk, _, b = CONV
    cases = {}
    for name in NAMES:
        mm, cv = f"matmul-{name}-{K}", f"conv-{name}-{K}"
        cases[mm + ":x"] = rng.normal(size=(T, D_IN)).astype(np.float32)
        cases[mm + ":w"] = (rng.normal(size=(D_IN, D_OUT)) / 4
                            ).astype(np.float32)
        cases[cv + ":x"] = rng.normal(size=(b, c_in, h, w)).astype(np.float32)
        cases[cv + ":w"] = (rng.normal(size=(c_out, c_in, kk, kk))
                            / (c_in * kk * kk) ** 0.5).astype(np.float32)
        cases[cv + ":spec"] = np.array(CONV)
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, [rank r's results]) of one 4-process gloo run."""
    d = tmp_path_factory.mktemp("sharded")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_sharded_worker.rank_main,
                         args=(r, WORLD, str(d / "store"),
                               str(d / "inputs.npz"), str(d)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(timeout=10)
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        [p.exitcode for p in procs]
    return inputs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _schemes(name):
    return make_scheme(tschemes, name, WORLD, K), \
        make_scheme(jschemes, name, WORLD, K)


@pytest.mark.parametrize("name", NAMES)
def test_coded_matmul_sharded(ranks, name):
    inputs, outs = ranks
    case = f"matmul-{name}-{K}"
    x, w = inputs[case + ":x"], inputs[case + ":w"]
    ts, js = _schemes(name)
    subset = ts.default_subset()
    assert js.default_subset() == subset
    want = jcl.coded_matmul(to_j(x), to_j(w), js, subset=subset)
    plain = x.astype(np.float64) @ w.astype(np.float64)
    tol = coded_tol(ts, subset, D_IN, plain)
    assert outs[0][case].shape == (T, D_OUT)
    assert_max_err(outs[0][case], want, tol, "vs the reference's stand-in")
    assert_max_err(outs[0][case], plain, tol, "vs the f64 product")
    # the port's functional form decodes the same subset from the same
    # pieces' math: within the same tolerance
    own = tcl.coded_matmul(torch.from_numpy(x), torch.from_numpy(w), ts,
                           subset=subset)
    assert_max_err(outs[0][case], own, tol, "vs the functional form")
    for r in range(1, WORLD):
        assert np.array_equal(outs[r][case], outs[0][case]), f"rank {r}"


@pytest.mark.parametrize("name", NAMES)
def test_coded_conv2d_sharded(ranks, name):
    inputs, outs = ranks
    case = f"conv-{name}-{K}"
    x, w = inputs[case + ":x"], inputs[case + ":w"]
    ts, js = _schemes(name)
    subset = ts.default_subset()
    assert js.default_subset() == subset
    jspec = jsplit.ConvSpec(*CONV)
    want = as_np(jcc.coded_conv2d(to_j(x), to_j(w), js, jspec,
                                  subset=subset))
    plain = as_np(jcc.conv2d(to_j(x), to_j(w), 1))
    c_in, _, _, _, kk, _, _ = CONV
    tol = coded_tol(ts, subset, c_in * kk * kk, plain)
    assert outs[0][case].shape == plain.shape
    assert_max_err(outs[0][case], want, tol, "vs the reference's stand-in")
    assert_max_err(outs[0][case], plain, tol, "vs the uncoded conv")
    for r in range(1, WORLD):
        assert np.array_equal(outs[r][case], outs[0][case]), f"rank {r}"


@pytest.fixture
def fake_world():
    """A default process group of 4 fake ranks (no collective runs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("form", ["matmul", "conv2d"])
def test_wrong_n_raises(fake_world, form):
    """The reference's contract: the axis extent must equal code.n."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, WORLD), mesh_dim_names=("data", "model"))
    code = tschemes.MDSScheme.make(WORLD + 1, 3)
    x = torch.zeros((9, 4))
    w = torch.zeros((4, 2))
    spec = tcc.ConvSpec(*CONV)
    with pytest.raises(ValueError, match="mesh axis model has size 4, "
                                         "code.n=5"):
        if form == "matmul":
            tcl.coded_matmul_sharded(x, w, code, mesh)
        else:
            tcc.coded_conv2d_sharded(torch.zeros((2, 4, 8, 12)),
                                     torch.zeros((6, 4, 3, 3)), code, spec,
                                     mesh)
    with pytest.raises(ValueError, match="no 'workers' axis"):
        tcl.coded_matmul_sharded(x, w, code, mesh, axis="workers")
