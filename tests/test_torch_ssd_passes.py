"""The SSD kernel's four passes (``ssd_cb``, ``ssd_states``,
``ssd_state_pass``, ``ssd_out``): their plain versions against the
reference's chunk-parallel formulas, their composition against the JAX
``ssd_chunked`` and the Pallas chunk kernel, and their launch plans.

Each pass's plain version is the function chip_smoke.py holds that pass's
CUDA kernel against on the card.  Here it is held against the same
intermediate written in numpy (f64) from ``repro/models/ssm.py::
ssd_chunked``: C B^T under the causal mask (G), the chunk states (S), the
states entering each chunk (Hin) and y.  The composition
``ssd_chunk_scan_passes_plain`` is held against the jitted reference
``ssd_chunked`` and, for one chunk, against ``ssd_chunk_pallas`` in
interpret mode.

Tolerance: every entry is a sum of products; two f32 orders of summation
differ by a few (N + L + c) u of the sum of the products' magnitudes
(the same function of |x|, |Bm|, |Cm|, |h0|), and ``exp(cum_l - cum_s)`` by
|cum| u, where |cum| is the largest running sum of dA in a chunk; a bf16
output adds one bf16 rounding on each side.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import U16, U32, as_np, assert_scaled_close, to_j, to_t
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro_torch.kernels._tiles import N_SMS, SMEM_LIMIT

# the module (the package exports the function of the same name)
K = importlib.import_module("repro_torch.kernels.ssd_chunk")

# (B, T, H, P, N): P > N, and N > P as in Mamba2-2.7B (P 64, N 128), narrowed
SHAPES = {"N<P": (2, 37, 3, 8, 4), "N>P": (2, 37, 2, 4, 16)}
CHUNKS = [4, 7, 16]  # 37 = 9*4+1 = 5*7+2 = 2*16+5: a ragged last chunk each


def _inputs(B, T, H, P, N, seed, h0=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    h = (rng.normal(size=(B, H, P, N)).astype(np.float32) if h0 else None)
    return x, dt, A, Bm, Cm, h


def np_passes(x, dt, A, Bm, Cm, h0, L):
    """The reference's chunk-parallel SSD in f64 numpy, intermediates
    kept: G, S, cum_end, Hin, the final state, y."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    c = -(-T // L)
    pad = c * L - T

    def chunked(a):
        a = np.concatenate([a, np.zeros((Bsz, pad) + a.shape[2:])], 1)
        return a.reshape((Bsz, c, L) + a.shape[2:])

    xr, dtr, Br, Cr = chunked(x), chunked(dt), chunked(Bm), chunked(Cm)
    cum = np.cumsum(dtr * A, axis=2)                        # (B, c, L, H)
    mask = np.tril(np.ones((L, L), bool))
    G = np.einsum("bcln,bcsn->bcls", Cr, Br) * mask
    decay_to_end = np.exp(cum[:, :, -1:] - cum)
    S = np.einsum("bcsn,bcsh,bcsh,bcshp->bchpn", Br, decay_to_end, dtr, xr)
    h = (np.zeros((Bsz, H, P, N)) if h0 is None
         else np.asarray(h0, np.float64))
    Hin = np.empty_like(S)
    for j in range(c):
        Hin[:, j] = h
        h = h * np.exp(cum[:, j, -1])[..., None, None] + S[:, j]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, c, l, s, H)
    Lmat = np.where(mask[None, None, :, :, None],
                    np.exp(np.minimum(seg, 0.0)), 0.0)
    y = (np.einsum("bclsh,bcls,bcsh,bcshp->bclhp", Lmat, G, dtr, xr)
         + np.einsum("bcln,bclh,bchpn->bclhp", Cr, np.exp(cum), Hin))
    y = y.reshape(Bsz, c * L, H, P)[:, :T]
    return {"G": G, "S": S, "cum_end": cum[:, :, -1], "Hin": Hin, "hT": h,
            "y": y, "max_cum": float(np.abs(cum).max())}


def _coef(N, L, c, max_cum, bf16=False):
    return 4.0 * (N + L + c + max_cum) * U32 + (2 * U16 if bf16 else 0.0)


def _case(shape, chunk, h0, seed=0):
    """Inputs, the numpy passes, their magnitudes and the tolerance."""
    B, T, H, P, N = shape
    x, dt, A, Bm, Cm, h = _inputs(*shape, seed=seed + 10 * chunk, h0=h0)
    ref = np_passes(x, dt, A, Bm, Cm, h, chunk)
    mag = np_passes(np.abs(x), dt, A, np.abs(Bm), np.abs(Cm),
                    None if h is None else np.abs(h), chunk)
    coef = _coef(N, chunk, -(-T // chunk), ref["max_cum"])
    return (x, dt, A, Bm, Cm, h), ref, mag, coef


CASES = [(name, chunk, h0) for name in SHAPES for chunk in CHUNKS
         for h0 in (False, True)]
IDS = [f"{n}-L{c}-{'h0' if h else 'zero'}" for n, c, h in CASES]


def _t(a):
    return None if a is None else to_t(a)


# ---------------------------------------------------------------------------
# each pass's plain version against the reference formula
# ---------------------------------------------------------------------------

class TestPassesPlain:
    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_cb(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        G = K.ssd_cb_plain(to_t(Bm), to_t(Cm), chunk)
        assert G.dtype == torch.float32 and tuple(G.shape) == ref["G"].shape
        assert_scaled_close(G, ref["G"], mag["G"], coef, "G")
        # zero above the diagonal, exactly
        assert not torch.triu(G, diagonal=1).any()

    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_states(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        S, cum_end = K.ssd_states_plain(to_t(x), to_t(dt), to_t(A),
                                        to_t(Bm), chunk)
        assert tuple(S.shape) == ref["S"].shape and S.dtype == torch.float32
        assert_scaled_close(S, ref["S"], mag["S"], coef, "S")
        assert_scaled_close(cum_end, ref["cum_end"], np.abs(ref["cum_end"]),
                            coef, "cum_end")

    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_state_pass(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        Hin, hT = K.ssd_state_pass_plain(to_t(ref["S"]), to_t(ref["cum_end"]),
                                         _t(h))
        assert tuple(Hin.shape) == ref["Hin"].shape
        assert_scaled_close(Hin, ref["Hin"], mag["Hin"], coef, "Hin")
        assert_scaled_close(hT, ref["hT"], mag["hT"], coef, "final state")
        # the first chunk enters with h0 itself
        want0 = np.zeros_like(ref["Hin"][:, 0]) if h is None else h
        np.testing.assert_array_equal(as_np(Hin[:, 0]), want0)

    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_out(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        y = K.ssd_out_plain(to_t(x), to_t(dt), to_t(A), to_t(Cm),
                            to_t(ref["G"]), to_t(ref["Hin"]), chunk)
        assert tuple(y.shape) == x.shape and y.dtype == torch.float32
        assert_scaled_close(y, ref["y"], mag["y"], coef, "y")

    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_composition(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        y, hT = K.ssd_chunk_scan_passes_plain(
            to_t(x), to_t(dt), to_t(A), to_t(Bm), to_t(Cm), _t(h), chunk)
        assert_scaled_close(y, ref["y"], mag["y"], coef, "y")
        assert_scaled_close(hT, ref["hT"], mag["hT"], coef, "final state")
        # and the one-chunk-at-a-time plain version computes the same
        py, ph = K.ssd_chunk_scan_plain(
            to_t(x), to_t(dt), to_t(A), to_t(Bm), to_t(Cm), _t(h), chunk)
        assert_scaled_close(y, py, mag["y"], 2 * coef, "y vs scan plain")
        assert_scaled_close(hT, ph, mag["hT"], 2 * coef, "h vs scan plain")

    def test_f64_inputs_stay_f64(self):
        """The passes' plain versions serve as their own f64 oracle."""
        (x, dt, A, Bm, Cm, h), ref, mag, _ = _case(SHAPES["N>P"], 7, True)
        d = torch.float64
        y, hT = K.ssd_chunk_scan_passes_plain(
            *(torch.from_numpy(a.astype(np.float64))
              for a in (x, dt, A, Bm, Cm, h)), chunk=7)
        assert y.dtype == d and hT.dtype == d
        assert_scaled_close(y, ref["y"], mag["y"], 64 * 2.0 ** -53, "y")
        assert_scaled_close(hT, ref["hT"], mag["hT"], 64 * 2.0 ** -53, "hT")


# ---------------------------------------------------------------------------
# the composition against the JAX reference
# ---------------------------------------------------------------------------

class TestAgainstReference:
    @pytest.mark.parametrize("name,chunk,h0", CASES, ids=IDS)
    def test_matches_jax_ssd_chunked(self, name, chunk, h0):
        (x, dt, A, Bm, Cm, h), ref, mag, coef = _case(SHAPES[name], chunk, h0)
        y, hT = K.ssd_chunk_scan_passes_plain(
            to_t(x), to_t(dt), to_t(A), to_t(Bm), to_t(Cm), _t(h), chunk)
        fn = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))
        jy, jh = fn(to_j(x), to_j(dt), to_j(A), to_j(Bm), to_j(Cm),
                    init_state=None if h is None else to_j(h))
        assert_scaled_close(y, jy, mag["y"], 2 * coef, "y vs ssd_chunked")
        assert_scaled_close(hT, jh, mag["hT"], 2 * coef,
                            "final state vs ssd_chunked")

    def test_bf16_x_matches_jax_ssd_chunked(self):
        B, T, H, P, N = SHAPES["N>P"]
        x, dt, A, Bm, Cm, _ = _inputs(B, T, H, P, N, seed=5)
        xb, Bb, Cb = (to_t(a, "bfloat16") for a in (x, Bm, Cm))
        y, hT = K.ssd_chunk_scan_passes_plain(xb, to_t(dt), to_t(A), Bb, Cb,
                                              None, 16)
        assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
        jy, jh = jssm.ssd_chunked(to_j(x, "bfloat16"), to_j(dt), to_j(A),
                                  to_j(Bm, "bfloat16"), to_j(Cm, "bfloat16"),
                                  chunk=16)
        # both sides start from the same bf16-rounded values
        xr, Br, Cr = (as_np(t) for t in (xb, Bb, Cb))
        ref = np_passes(xr, dt, A, Br, Cr, None, 16)
        mag = np_passes(np.abs(xr), dt, A, np.abs(Br), np.abs(Cr), None, 16)
        coef = _coef(N, 16, 3, ref["max_cum"], bf16=True)
        assert_scaled_close(y, jy, mag["y"], 2 * coef, "y vs ssd_chunked")
        assert_scaled_close(y, ref["y"], mag["y"], coef, "y vs numpy")
        assert_scaled_close(hT, jh, mag["hT"], 2 * coef, "final state")

    @pytest.mark.parametrize("L", [7, 16])
    def test_one_chunk_matches_pallas_interpret(self, L):
        B, _, H, P, N = SHAPES["N>P"]
        x, dt, A, Bm, Cm, h = _inputs(B, L, H, P, N, seed=L, h0=True)
        y, hT = K.ssd_chunk_scan_passes_plain(
            to_t(x), to_t(dt), to_t(A), to_t(Bm), to_t(Cm), to_t(h), L)
        jy, jh = jops.ssd_chunk(*(to_j(a) for a in (x, dt, A, Bm, Cm, h)),
                                interpret=True)
        ref = np_passes(x, dt, A, Bm, Cm, h, L)
        mag = np_passes(np.abs(x), dt, A, np.abs(Bm), np.abs(Cm), np.abs(h), L)
        coef = _coef(N, L, 1, ref["max_cum"])
        assert_scaled_close(y, jy, mag["y"], 2 * coef, "y vs Pallas")
        assert_scaled_close(hT, jh, mag["hT"], 2 * coef, "h1 vs Pallas")


# ---------------------------------------------------------------------------
# the pass wrappers on the CPU
# ---------------------------------------------------------------------------

def test_pass_wrappers_take_the_plain_versions_on_cpu():
    (x, dt, A, Bm, Cm, h), ref, _, _ = _case(SHAPES["N<P"], 7, True)
    xt, dtt, At, Bt, Ct, ht = (to_t(a) for a in (x, dt, A, Bm, Cm, h))
    before = (K.ssd_chunk.launches, dict(K.ssd_chunk.pass_launches))
    G = K.ssd_cb(Bt, Ct, 7)
    assert torch.equal(G, K.ssd_cb_plain(Bt, Ct, 7))
    S, ce = K.ssd_states(xt, dtt, At, Bt, 7)
    pS, pce = K.ssd_states_plain(xt, dtt, At, Bt, 7)
    assert torch.equal(S, pS) and torch.equal(ce, pce)
    Hin, hT = K.ssd_state_pass(S, ce, ht)
    pHin, phT = K.ssd_state_pass_plain(S, ce, ht)
    assert torch.equal(Hin, pHin) and torch.equal(hT, phT)
    y = K.ssd_out(xt, dtt, At, Ct, G, Hin, 7)
    assert torch.equal(y, K.ssd_out_plain(xt, dtt, At, Ct, G, Hin, 7))
    assert (K.ssd_chunk.launches, K.ssd_chunk.pass_launches) == before
    assert set(K.ssd_chunk.pass_launches) == set(K.PASSES)


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

ZAMBA2 = (8, 512, 64, 64, 64, 128)         # B, T, H, P, N, chunk
ZAMBA2_T200 = (4, 200, 64, 64, 64, 128)
MAMBA2_2P7B = (2, 512, 80, 64, 128, 128)


@pytest.mark.parametrize("shape", [ZAMBA2, ZAMBA2_T200, MAMBA2_2P7B],
                         ids=["zamba2", "zamba2-T200", "mamba2-2.7b"])
def test_plan_grids_and_occupancy(shape):
    """The grids are the chunk-parallel ones (no pass but the state pass
    walks the chunks), C B^T has one block per tile of a (batch, chunk) —
    not per head — and every pass fits at least 2 blocks per SM."""
    B, T, H, P, N, L = shape
    c = -(-T // L)
    plan = K.ssd_plan(*shape)
    assert tuple(plan) == K.PASSES
    assert plan["cb"].grid == (1 if L <= 64 else 4, c, B)
    assert plan["states"].grid == (H, c, B)
    assert plan["out"].grid == (H, c, B)
    assert plan["state_pass"].grid == (-(-P * N // 256), H, B)
    for name, p in plan.items():
        assert p.smem <= SMEM_LIMIT, name
        assert p.blocks_per_sm >= 2, (name, p)
    # the per-head passes give the card several waves of blocks
    assert plan["states"].blocks >= N_SMS and plan["out"].blocks >= N_SMS


def test_plan_smem_at_the_headline_shape():
    """Shared memory of each pass at Zamba2's widths (bytes), as the
    kernel's source states it."""
    plan = K.ssd_plan(*ZAMBA2)
    assert {k: p.smem for k, p in plan.items()} == {
        "cb": 34_816, "states": 75_264, "state_pass": 0, "out": 83_968}
    assert {k: p.blocks_per_sm for k, p in plan.items()} == {
        "cb": 6, "states": 3, "state_pass": 8, "out": 2}
    big = K.ssd_plan(*MAMBA2_2P7B)
    assert (big["cb"].smem, big["states"].smem, big["out"].smem) == (
        67_584, 108_032, 83_968)


@pytest.mark.parametrize("L", [1, 7, 16, 64, 65, 72, 127, 128])
@pytest.mark.parametrize("P,N", [(1, 1), (20, 12), (64, 64), (64, 128),
                                 (33, 100)])
def test_plan_fits_a_block_everywhere_in_the_limits(L, P, N):
    plan = K.ssd_plan(3, 300, 5, P, N, L)
    assert all(p.smem <= SMEM_LIMIT for p in plan.values())
    assert plan["states"].grid[1] == plan["out"].grid[1] == -(-300 // L)


@pytest.mark.parametrize("args", [(1, 8, 1, 4, 4, 129), (1, 8, 1, 65, 4, 8),
                                  (1, 8, 1, 4, 129, 8), (1, 8, 1, 4, 4, 0)])
def test_plan_rejects_out_of_limits(args):
    with pytest.raises(ValueError):
        K.ssd_plan(*args)
