"""The SSD chunk's plain versions and the port's Mamba2 block vs the JAX
reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel in interpret mode through ``repro.kernels.ops.ssd_chunk`` and the
sequential-scan oracle ``ssd_chunk_ref``.  The port side runs its wrappers
on CPU tensors, which take the plain PyTorch versions — the same functions
chip_smoke.py holds the CUDA kernel against on the card.  Tolerances are
the reference's own (f32 1e-4, bf16 5e-2); the f32 one grows with the
largest |cumulative dA| of the chunk, because ``exp(cum_l - cum_s)`` loses
about |cum| units of f32 roundoff in the difference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, to_j, to_t
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_chunk_ref as j_ssd_ref
from repro.models import ssm as jssm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_plain,
                                           ssd_chunk_scan,
                                           ssd_chunk_scan_plain)
from repro_torch.models import ssm as tssm

SHAPES = [(1, 8, 2, 4, 4), (2, 16, 4, 8, 16), (3, 32, 8, 16, 8)]
DTYPES = ["float32", "bfloat16"]


def _inputs(B, L, H, P, N, seed, h0=False):
    """x, dt, A, Bm, Cm, h0 as f32 numpy, drawn like TestSSDKernel's."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    h = (rng.normal(size=(B, H, P, N)) if h0 else
         np.zeros((B, H, P, N))).astype(np.float32)
    return x, dt, A, Bm, Cm, h


def _tol(dtype, dt, A):
    """The reference tests' tolerance; f32 scaled by max(1, |cum dA|)."""
    if dtype == "bfloat16":
        return dict(rtol=5e-2, atol=5e-2)
    cum = float(np.abs(np.cumsum(dt * A, axis=1)).max())
    t = 1e-4 * max(1.0, cum)
    return dict(rtol=t, atol=t)


def _close(got, want, tol, what):
    np.testing.assert_allclose(as_np(got), as_np(want), err_msg=what, **tol)


class TestSSDChunk:
    @pytest.mark.parametrize("B,L,H,P,N", SHAPES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_pallas_and_sequential_scan(self, B, L, H, P, N, dtype):
        x, dt, A, Bm, Cm, h0 = _inputs(B, L, H, P, N, L * H)
        # x, Bm, Cm and dt in the working type on both sides; A, h0 in f32
        xt, Bt, Ct, dtt = (to_t(a, dtype) for a in (x, Bm, Cm, dt))
        y, h1 = tops.ssd_chunk(xt, dtt, to_t(A), Bt, Ct, to_t(h0))
        assert y.dtype == xt.dtype and h1.dtype == torch.float32
        assert tuple(y.shape) == (B, L, H, P) and tuple(h1.shape) == (B, H, P, N)
        jy, jh = jops.ssd_chunk(to_j(x, dtype), to_j(dt, dtype), to_j(A),
                                to_j(Bm, dtype), to_j(Cm, dtype), to_j(h0),
                                interpret=True)
        tol = _tol(dtype, dt, A)
        _close(y, jy, tol, "y vs Pallas")
        _close(h1, jh, tol, "h1 vs Pallas")
        xr, Br, Cr, dtr = (as_np(t) for t in (xt, Bt, Ct, dtt))
        for b in range(B):
            ry, rh = j_ssd_ref(jnp.asarray(xr[b]), jnp.asarray(dtr[b]),
                               jnp.asarray(A), jnp.asarray(Br[b]),
                               jnp.asarray(Cr[b]), jnp.asarray(h0[b]))
            _close(y[b], ry, tol, "y vs sequential scan")
            _close(h1[b], rh, tol, "h1 vs sequential scan")

    def test_nonzero_initial_state(self):
        x, dt, A, Bm, Cm, h0 = _inputs(1, 8, 2, 4, 4, 9, h0=True)
        y, h1 = tops.ssd_chunk(*(to_t(a) for a in (x, dt, A, Bm, Cm, h0)))
        jy, jh = jops.ssd_chunk(*(to_j(a) for a in (x, dt, A, Bm, Cm, h0)),
                                interpret=True)
        ry, rh = j_ssd_ref(*(jnp.asarray(a[0]) for a in (x, dt)),
                           jnp.asarray(A),
                           *(jnp.asarray(a[0]) for a in (Bm, Cm, h0)))
        tol = _tol("float32", dt, A)
        _close(y, jy, tol, "y vs Pallas")
        _close(h1, jh, tol, "h1 vs Pallas")
        _close(y[0], ry, tol, "y vs scan")
        _close(h1[0], rh, tol, "h1 vs scan")

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_port_oracle_matches_reference_oracle(self, dtype):
        """The port's ssd_chunk_ref (the f64 oracle chip_smoke.py uses)
        is the reference's scan."""
        x, dt, A, Bm, Cm, h0 = _inputs(1, 12, 3, 4, 5, 3, h0=True)
        tdt = torch.float64 if dtype == "float64" else torch.float32
        ty, th = tref.ssd_chunk_ref(*(torch.from_numpy(a[0]).to(tdt)
                                      for a in (x, dt)),
                                    torch.from_numpy(A).to(tdt),
                                    *(torch.from_numpy(a[0]).to(tdt)
                                      for a in (Bm, Cm, h0)))
        assert ty.dtype == tdt and th.dtype == tdt
        jy, jh = j_ssd_ref(*(jnp.asarray(a[0]) for a in (x, dt)),
                           jnp.asarray(A),
                           *(jnp.asarray(a[0]) for a in (Bm, Cm, h0)))
        tol = _tol("float32", dt[:1], A)
        _close(ty, jy, tol, "y")
        _close(th, jh, tol, "h")


class TestSSDScan:
    @pytest.mark.parametrize("T,chunk", [(37, 16), (16, 16), (5, 16),
                                         (40, 8)])
    @pytest.mark.parametrize("init", [False, True])
    def test_ssd_chunked_matches_reference(self, T, chunk, init):
        """The port's ssd_chunked (the scan wrapper, padded ragged tail) vs
        the reference's chunked dual form, with and without init_state."""
        x, dt, A, Bm, Cm, h0 = _inputs(2, T, 4, 8, 6, T + chunk, h0=init)
        st = to_t(h0) if init else None
        y, h = tssm.ssd_chunked(to_t(x), to_t(dt), to_t(A), to_t(Bm),
                                to_t(Cm), chunk=chunk, init_state=st)
        ref = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))
        jy, jh = ref(to_j(x), to_j(dt), to_j(A), to_j(Bm), to_j(Cm),
                     init_state=to_j(h0) if init else None)
        tol = _tol("float32", dt, A)
        _close(y, jy, tol, "y")
        _close(h, jh, tol, "final state")

    def test_bf16_ssd_chunked_matches_reference(self):
        x, dt, A, Bm, Cm, _ = _inputs(2, 37, 4, 8, 6, 5)
        y, h = tssm.ssd_chunked(to_t(x, "bfloat16"), to_t(dt), to_t(A),
                                to_t(Bm, "bfloat16"), to_t(Cm, "bfloat16"),
                                chunk=16)
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        jy, jh = jssm.ssd_chunked(to_j(x, "bfloat16"), to_j(dt), to_j(A),
                                  to_j(Bm, "bfloat16"), to_j(Cm, "bfloat16"),
                                  chunk=16)
        tol = _tol("bfloat16", dt, A)
        _close(y, jy, tol, "y")
        _close(h, jh, tol, "final state")

    def test_scan_of_one_chunk_is_the_chunk(self):
        x, dt, A, Bm, Cm, h0 = (to_t(a) for a in
                                _inputs(2, 16, 4, 8, 6, 1, h0=True))
        y1, h1 = ssd_chunk(x, dt, A, Bm, Cm, h0)
        y2, h2 = ssd_chunk_scan(x, dt, A, Bm, Cm, h0, chunk=16)
        assert torch.equal(y1, y2) and torch.equal(h1, h2)

    def test_chunk_length_changes_only_roundoff(self):
        """The same sequence in chunks of 4, 7 and 32 (one chunk)."""
        x, dt, A, Bm, Cm, h0 = (to_t(a) for a in
                                _inputs(1, 29, 2, 4, 3, 2, h0=True))
        y0, h0_ = ssd_chunk_scan_plain(x, dt, A, Bm, Cm, h0, chunk=32)
        for chunk in (4, 7):
            y, h = ssd_chunk_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
            tol = dict(rtol=1e-4, atol=1e-4)
            _close(y, y0, tol, f"y, chunk {chunk}")
            _close(h, h0_, tol, f"h, chunk {chunk}")


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_and_count_no_launch(self):
        n0 = ssd_chunk.launches
        x, dt, A, Bm, Cm, h0 = (to_t(a) for a in _inputs(1, 8, 2, 4, 4, 0))
        y, h = ssd_chunk(x, dt, A, Bm, Cm, h0)
        py, ph = ssd_chunk_plain(x, dt, A, Bm, Cm, h0)
        assert torch.equal(y, py) and torch.equal(h, ph)
        ssd_chunk_scan(x, dt, A, Bm, Cm, None, chunk=3)
        assert ssd_chunk.launches == n0

    @pytest.mark.parametrize("shapes", [
        ((1, 8, 2, 4), (1, 8, 3), (2,), (1, 8, 4), (1, 8, 4)),   # dt heads
        ((1, 8, 2, 4), (1, 8, 2), (2,), (1, 7, 4), (1, 8, 4)),   # Bm length
        ((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 4), (1, 8, 5)),   # Cm state
        ((8, 2, 4), (1, 8, 2), (2,), (1, 8, 4), (1, 8, 4)),      # x rank
        ((1, 0, 2, 4), (1, 0, 2), (2,), (1, 0, 4), (1, 0, 4)),   # empty
    ])
    def test_rejects_bad_shapes(self, shapes):
        xs, ds, As, bs, cs = shapes
        args = [torch.ones(s) for s in (xs, ds, As, bs, cs)]
        with pytest.raises(ValueError):
            ssd_chunk_scan(*args, None, chunk=4)

    def test_rejects_bad_h0_and_chunk(self):
        x, dt, A, Bm, Cm, h0 = (to_t(a) for a in _inputs(1, 8, 2, 4, 4, 0))
        with pytest.raises(ValueError):
            ssd_chunk(x, dt, A, Bm, Cm, h0[:, :1])
        with pytest.raises(ValueError):
            ssd_chunk(x, dt, A, Bm, Cm, None)
        with pytest.raises(ValueError):
            ssd_chunk_scan(x, dt, A, Bm, Cm, h0, chunk=0)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

DIMS = dict(d_model=32, d_state=8, expand=2, head_dim=16, conv_width=4)


@pytest.fixture(scope="module")
def mamba_params():
    jdims = jssm.SSMDims(**DIMS)
    jp = jssm.init_mamba_params(jax.random.PRNGKey(3), jdims, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jdims, jp, tssm.SSMDims(**DIMS), tp


def test_mamba_forward_matches_reference(mamba_params):
    jdims, jp, tdims, tp = mamba_params
    x = np.random.default_rng(4).normal(size=(2, 21, 32)).astype(np.float32)
    y, st = tssm.mamba_forward(tp, to_t(x), tdims, chunk=8)
    ref = jax.jit(functools.partial(jssm.mamba_forward, dims=jdims, chunk=8))
    jy, jst = ref(jp, to_j(x))
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(y, jy, tol, "out")
    _close(st.conv, jst.conv, tol, "conv state")
    _close(st.ssm, jst.ssm, tol, "ssm state")


def test_mamba_step_matches_reference(mamba_params):
    jdims, jp, tdims, tp = mamba_params
    rng = np.random.default_rng(5)
    conv = rng.normal(size=(3, tdims.conv_dim, 3)).astype(np.float32)
    ssm = rng.normal(size=(3, tdims.n_heads, 16, 8)).astype(np.float32)
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    y, st = tssm.mamba_step(tp, to_t(x),
                            tssm.MambaState(to_t(conv), to_t(ssm)), tdims)
    ref = jax.jit(functools.partial(jssm.mamba_step, dims=jdims))
    jy, jst = ref(jp, to_j(x), jssm.MambaState(to_j(conv), to_j(ssm)))
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(y, jy, tol, "out")
    _close(st.conv, jst.conv, tol, "conv state")
    _close(st.ssm, jst.ssm, tol, "ssm state")


def test_forward_then_steps_equal_longer_forward(mamba_params):
    """Within the port: prefill T tokens, step 3 more, and the outputs
    equal a forward over T + 3 (the recurrent and the dual forms agree)."""
    _, _, tdims, tp = mamba_params
    x = to_t(np.random.default_rng(6).normal(size=(2, 19, 32)))
    full, _ = tssm.mamba_forward(tp, x, tdims, chunk=8)
    y, st = tssm.mamba_forward(tp, x[:, :16], tdims, chunk=8)
    outs = [y]
    for t in range(16, 19):
        yt, st = tssm.mamba_step(tp, x[:, t:t + 1], st, tdims)
        outs.append(yt)
    _close(torch.cat(outs, 1), full, dict(rtol=1e-4, atol=1e-4), "steps")


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(7)
    B, H, P, N = 2, 3, 4, 5
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, H))).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, N)).astype(np.float32)
    Cm = rng.normal(size=(B, N)).astype(np.float32)
    y, s = tssm.ssd_step(*(to_t(a) for a in (state, x, dt, A, Bm, Cm)))
    jy, js = jssm.ssd_step(*(to_j(a) for a in (state, x, dt, A, Bm, Cm)))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(y, jy, tol, "y")
    _close(s, js, tol, "state")


def test_mamba_state_and_dims_match_reference():
    jd, td = jssm.SSMDims(**DIMS), tssm.SSMDims(**DIMS)
    for f in ("d_inner", "n_heads", "conv_dim", "in_proj_dim"):
        assert getattr(jd, f) == getattr(td, f)
    st = tssm.init_mamba_state(td, 2, torch.float32, device="cpu")
    jst = jssm.init_mamba_state(jd, 2, jnp.float32)
    assert tuple(st.conv.shape) == jst.conv.shape
    assert tuple(st.ssm.shape) == jst.ssm.shape and st.ssm.dtype == torch.float32
    with pytest.raises(ValueError):
        tssm.SSMDims(d_model=30, d_state=4, head_dim=16).n_heads
