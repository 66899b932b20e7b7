"""The SSD backward: the reversed passes' plain versions (what the CUDA
kernel ``csrc/ssd_chunk_bwd.cu`` computes, pass by pass) and the
``torch.autograd.Function`` that runs the scan with it.

* In f64 the composed plain backward equals autograd through the passes'
  plain forward to 1e-12 of each gradient's largest magnitude: the
  formulas are the forward's derivative exactly.
* In f32 it is held against ``jax.grad`` of the reference's
  ``models/ssm.py::ssd_chunked`` on the same numpy inputs (ragged T, with
  and without h0, with and without the final state's gradient), within
  2e-5 of each gradient's largest magnitude: f32 sums of at most a few
  hundred products here, taken in other orders (~10^2 2^-24 = 6e-6 of the
  sum of magnitudes).
* ``models.ssm.ssd_chunked`` under autograd gives the same gradients as
  autograd through the plain forward (same tolerance), keeps nothing and
  computes the serving path's values under ``no_grad``, and the backward
  plans pin their shared memory against the kernel's limits.
"""
import functools
import importlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, to_j, to_t
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

K = importlib.import_module("repro_torch.kernels.ssd_chunk")
CSRC = Path(K.__file__).resolve().parent / "csrc"

CASES = [
    # B, T, H, P, N, chunk, h0, dhT
    (2, 16, 2, 4, 4, 8, False, False),
    (2, 21, 3, 5, 6, 8, True, True),     # ragged last chunk
    (1, 32, 2, 8, 4, 16, True, False),
    (2, 7, 2, 3, 5, 16, False, True),    # one ragged chunk
]
TOL32 = 2e-5


def _inputs(B, T, H, P, N, h0, dhT, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(B, T, H, P)).astype(f),
        dt=(np.log1p(np.exp(rng.normal(size=(B, T, H)) - 1.0))).astype(f),
        A=-np.linspace(0.5, 3.0, H).astype(f),
        Bm=rng.normal(size=(B, T, N)).astype(f),
        Cm=rng.normal(size=(B, T, N)).astype(f),
        h0=rng.normal(size=(B, H, P, N)).astype(f) if h0 else None,
        dy=rng.normal(size=(B, T, H, P)).astype(f),
        dhT=rng.normal(size=(B, H, P, N)).astype(f) if dhT else None)


def _rel_close(got, want, rel, what):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: err {err:.3g} > {rel} * {scale:.3g}"


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


@pytest.mark.parametrize("B,T,H,P,N,chunk,h0,dhT", CASES)
def test_plain_backward_is_the_forward_derivative_in_f64(B, T, H, P, N,
                                                         chunk, h0, dhT):
    d = _inputs(B, T, H, P, N, h0, dhT, seed=T + H)
    t = {k: None if v is None else torch.from_numpy(v).double()
         for k, v in d.items()}
    ins = [t[k].requires_grad_(True) for k in ("x", "dt", "A", "Bm", "Cm")]
    if h0:
        ins.append(t["h0"].requires_grad_(True))
    y, hT = K.ssd_chunk_scan_passes_plain(*ins[:5], t["h0"], chunk)
    obj = (y * t["dy"]).sum() + ((hT * t["dhT"]).sum() if dhT else 0.0)
    want = torch.autograd.grad(obj, ins)
    with torch.no_grad():
        _, _, saved = K.ssd_chunk_scan_train(*ins[:5], t["h0"], chunk)
        got = K.ssd_chunk_scan_bwd(*ins[:5], saved, t["dy"], t["dhT"], chunk,
                                   want_dh0=h0)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64
        _rel_close(g, w, 1e-12, n)
    if not h0:
        assert got[5] is None


@functools.lru_cache(maxsize=None)
def _jax_grad(chunk: int, h0: bool, dhT: bool):
    def obj(x, dt, A, Bm, Cm, h, dy, dh):
        y, hT = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=h if h0 else None)
        out = jnp.sum(y * dy)
        return out + jnp.sum(hT * dh) if dhT else out
    return jax.jit(jax.grad(obj, argnums=(0, 1, 2, 3, 4, 5)))


@pytest.mark.parametrize("B,T,H,P,N,chunk,h0,dhT", CASES)
def test_backward_matches_jax_grad_of_the_reference(B, T, H, P, N, chunk,
                                                    h0, dhT):
    d = _inputs(B, T, H, P, N, h0, dhT, seed=2 * T + N)
    zeros = np.zeros((B, H, P, N), np.float32)
    want = _jax_grad(chunk, h0, dhT)(
        *(to_j(d[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
        to_j(d["h0"] if h0 else zeros), to_j(d["dy"]),
        to_j(d["dhT"] if dhT else zeros))
    t = {k: None if v is None else to_t(v) for k, v in d.items()}
    # the plain backward from the plain forward's saved tensors
    _, _, saved = K.ssd_chunk_scan_train(t["x"], t["dt"], t["A"], t["Bm"],
                                         t["Cm"], t["h0"], chunk)
    got = K.ssd_chunk_scan_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                               saved, t["dy"], t["dhT"], chunk, want_dh0=h0)
    for n, g, w in zip(NAMES[:6 if h0 else 5], got, want):
        assert g.dtype == torch.float32
        _rel_close(g, w, TOL32, f"plain backward {n}")
    # the same through the model's ssd_chunked under autograd
    ins = [t[k].clone().requires_grad_(True)
           for k in ("x", "dt", "A", "Bm", "Cm")]
    h = t["h0"].clone().requires_grad_(True) if h0 else None
    y, hT = tssm.ssd_chunked(*ins, chunk=chunk, init_state=h)
    assert y.grad_fn is not None and hT.grad_fn is not None
    obj = (y * t["dy"]).sum() + ((hT * t["dhT"]).sum() if dhT else 0.0)
    grads = torch.autograd.grad(obj, ins + ([h] if h0 else []))
    for n, g, w in zip(NAMES, grads, want):
        _rel_close(g, w, TOL32, f"ssd_chunked {n}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunked_autograd_matches_autograd_of_the_plain_forward(dtype):
    B, T, H, P, N, chunk = 2, 20, 2, 4, 6, 8
    d = _inputs(B, T, H, P, N, True, True, seed=7)
    cast = lambda k: to_t(d[k]).to(dtype if k in ("x", "Bm", "Cm")
                                   else torch.float32)

    def grads(fn):
        ins = [cast(k).requires_grad_(True)
               for k in ("x", "dt", "A", "Bm", "Cm", "h0")]
        y, hT = fn(*ins)
        obj = (y.float() * to_t(d["dy"])).sum() + (hT * to_t(d["dhT"])).sum()
        return torch.autograd.grad(obj, ins)

    got = grads(lambda x, dt, A, Bm, Cm, h: tssm.ssd_chunked(
        x, dt, A, Bm, Cm, chunk=chunk, init_state=h))
    want = grads(lambda x, dt, A, Bm, Cm, h: K.ssd_chunk_scan_passes_plain(
        x, dt, A, Bm, Cm, h, chunk))
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype  # each gradient in its input's type
        _rel_close(g, w, TOL32 if dtype == torch.float32 else 2 ** -7, n)


def test_ssd_chunked_without_autograd_is_the_serving_path():
    d = _inputs(2, 20, 2, 4, 6, True, False, seed=3)
    t = {k: None if v is None else to_t(v) for k, v in d.items()}
    args = [t[k] for k in ("x", "dt", "A", "Bm", "Cm")]
    want = K.ssd_chunk_scan(*args, t["h0"], 8)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            req = [a.clone().requires_grad_(True) for a in args]
            got = tssm.ssd_chunked(*req, chunk=8, init_state=t["h0"])
        assert got[0].grad_fn is None
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = tssm.ssd_chunked(*args, chunk=8, init_state=t["h0"])
    assert got[0].grad_fn is None and torch.equal(got[0], want[0])


def test_backward_passes_compose_to_the_whole():
    B, T, H, P, N, chunk = 2, 21, 3, 5, 6, 8
    d = _inputs(B, T, H, P, N, True, True, seed=11)
    t = {k: to_t(v).double() for k, v in d.items()}
    x, dt, A, Bm, Cm, h0, dy, dhT = (t[k] for k in ("x", "dt", "A", "Bm",
                                                    "Cm", "h0", "dy", "dhT"))
    _, _, (G, Hin, ce) = K.ssd_chunk_scan_train(x, dt, A, Bm, Cm, h0, chunk)
    o = K.ssd_out_bwd(x, dt, A, Cm, G, Hin, dy, chunk)
    c = -(-T // chunk)
    ng = -(-H // K.bwd_heads(B, T, H, chunk))
    assert [tuple(a.shape) for a in o] == [
        (B, T, H, P), (B, c, ng, chunk, chunk), (B, c, ng, chunk, N),
        (B, c, H, P, N), (B, c, H, chunk), (B, c, H, chunk)]
    dS, dce, dh0 = K.ssd_state_pass_bwd(Hin, ce, o[3], dhT)
    dx, dB_g, ddt, dA_part = K.ssd_states_bwd(x, dt, A, Bm, dS, o[4], o[5],
                                              dce, o[0], chunk)
    assert tuple(dB_g.shape) == (B, c, ng, chunk, N)
    dB, dC, dA = K.ssd_cb_bwd(Bm, Cm, o[1], dB_g, o[2], dA_part, chunk)
    whole = K.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, (G, Hin, ce), dy, dhT,
                                 chunk)
    for a, b in zip((dx, ddt, dA, dB, dC, dh0), whole):
        assert torch.equal(a, b)
    # a group's share of dG is causal: zero above the diagonal
    assert not o[1].triu(1).any()


def _old_per_head(x, dt, A, Bm, Cm, saved, dy, dhT, chunk):
    """The passes as they ran before the heads were grouped: one group a
    head, so that the out and states passes hand on each head's dGh, dCh
    and dBh and cb_bwd sums all of them."""
    G, Hin, ce = saved
    o = K.ssd_out_bwd_plain(x, dt, A, Cm, G, Hin, dy, chunk, heads=1)
    dS, dce, dh0 = K.ssd_state_pass_bwd_plain(Hin, ce, o[3], dhT)
    s = K.ssd_states_bwd_plain(x, dt, A, Bm, dS, o[4], o[5], dce, o[0],
                               chunk, heads=1)
    return o, (dS, dce, dh0), s


GROUPINGS = [
    # B, T, H, P, N, chunk, heads (the last group short where H % heads)
    (2, 21, 3, 5, 6, 8, 2),
    (2, 21, 3, 5, 6, 8, 3),
    (1, 32, 5, 4, 3, 16, 2),
    (1, 32, 5, 4, 3, 16, 4),
]


@pytest.mark.parametrize("B,T,H,P,N,chunk,heads", GROUPINGS)
def test_grouped_passes_equal_the_per_head_passes(B, T, H, P, N, chunk,
                                                  heads):
    """Each pass that sums a group of heads (out_bwd's dG_g and dC_g,
    states_bwd's dB_g) holds the sum of the per-head passes' shares over
    the group, its other outputs are theirs, and cb_bwd on the groups
    gives the per-head composition's dB, dC, dA: in f64 to 1e-12."""
    d = _inputs(B, T, H, P, N, True, True, seed=B + T + heads)
    t = {k: to_t(v).double() for k, v in d.items()}
    x, dt, A, Bm, Cm, h0, dy, dhT = (t[k] for k in ("x", "dt", "A", "Bm",
                                                    "Cm", "h0", "dy", "dhT"))
    _, _, saved = K.ssd_chunk_scan_train(x, dt, A, Bm, Cm, h0, chunk)
    o1, (dS, dce, _), s1 = _old_per_head(x, dt, A, Bm, Cm, saved, dy, dhT,
                                         chunk)
    G, Hin, ce = saved
    o = K.ssd_out_bwd_plain(x, dt, A, Cm, G, Hin, dy, chunk, heads=heads)
    s = K.ssd_states_bwd_plain(x, dt, A, Bm, dS, o[4], o[5], dce, o[0],
                               chunk, heads=heads)
    ng = -(-H // heads)
    for j in range(ng):
        hs = slice(j * heads, min(H, (j + 1) * heads))
        _rel_close(o[1][:, :, j], o1[1][:, :, hs].sum(2), 1e-12, "dG_g")
        _rel_close(o[2][:, :, j], o1[2][:, :, hs].sum(2), 1e-12, "dC_g")
        _rel_close(s[1][:, :, j], s1[1][:, :, hs].sum(2), 1e-12, "dB_g")
    for i in (0, 3, 4, 5):
        assert torch.equal(o[i], o1[i])
    for i in (0, 2, 3):
        assert torch.equal(s[i], s1[i])
    got = K.ssd_cb_bwd_plain(Bm, Cm, o[1], s[1], o[2], s[3], chunk)
    want = K.ssd_cb_bwd_plain(Bm, Cm, o1[1], s1[1], o1[2], s1[3], chunk)
    for n, a, b in zip(("dB", "dC", "dA"), got, want):
        _rel_close(a, b, 1e-12, n)


@pytest.mark.parametrize("B,T,H,P,N,chunk,heads", GROUPINGS)
def test_grouped_passes_compose_to_the_f64_derivative(B, T, H, P, N, chunk,
                                                      heads):
    """The grouped passes composed equal autograd through the plain
    forward in f64 (1e-12) and ``jax.grad`` of the reference's
    ``ssd_chunked`` in f32 (TOL32)."""
    d = _inputs(B, T, H, P, N, True, True, seed=3 * T + heads)
    names = ("x", "dt", "A", "Bm", "Cm")

    def composed(t):
        _, _, saved = K.ssd_chunk_scan_train(*(t[k] for k in names),
                                             t["h0"], chunk)
        G, Hin, ce = saved
        x, dt, A, Bm, Cm = (t[k] for k in names)
        o = K.ssd_out_bwd_plain(x, dt, A, Cm, G, Hin, t["dy"], chunk,
                                heads=heads)
        dS, dce, dh0 = K.ssd_state_pass_bwd_plain(Hin, ce, o[3], t["dhT"])
        dx, dB_g, ddt, dA_part = K.ssd_states_bwd_plain(
            x, dt, A, Bm, dS, o[4], o[5], dce, o[0], chunk, heads=heads)
        dB, dC, dA = K.ssd_cb_bwd_plain(Bm, Cm, o[1], dB_g, o[2], dA_part,
                                        chunk)
        return dx, ddt, dA, dB, dC, dh0

    t64 = {k: torch.from_numpy(v).double() for k, v in d.items()}
    ins = [t64[k].requires_grad_(True) for k in names + ("h0",)]
    y, hT = K.ssd_chunk_scan_passes_plain(*ins, chunk)
    want = torch.autograd.grad((y * t64["dy"]).sum()
                               + (hT * t64["dhT"]).sum(), ins)
    with torch.no_grad():
        got = composed({k: v.detach() for k, v in t64.items()})
    for n, g, w in zip(NAMES, got, want):
        _rel_close(g, w, 1e-12, n)
    jgot = _jax_grad(chunk, True, True)(
        *(to_j(d[k]) for k in names + ("h0", "dy", "dhT")))
    got32 = composed({k: to_t(v) for k, v in d.items()})
    for n, g, w in zip(NAMES, got32, jgot):
        _rel_close(g, w, TOL32, f"grouped {n}")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cu_const(name: str) -> int:
    text = (CSRC / "ssd_chunk_bwd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _kernel_smem(L, P, N):
    """The shared memory of each pass as ``csrc/ssd_chunk_bwd.cu`` writes
    it (smem_out_bwd, smem_states_bwd, smem_cb_bwd), transcribed apart
    from ``ssd_bwd_plan``."""
    up = lambda a, b: -(-a // b) * b
    sa = lambda n: up(n, 8) + 4
    sb = lambda n: up(n, 16) + 8
    l16, rt, lmax = up(L, 16), _cu_const("RT"), 128
    xs = max(l16 * sb(P), up(P, 8) * sa(N))
    us = l16 * (sb(L) if L > N else sb(N))
    return {
        "out_bwd": 4 * (xs + us + l16 * sb(P) + l16 * sb(N)
                        + _cu_const("NSMALL") * lmax),
        "state_pass_bwd": 0,
        "states_bwd": 4 * (l16 * sa(P) + 2 * l16 * sb(N) + up(P, 8) * sb(N)
                           + 8 * lmax),
        "cb_bwd": 4 * (l16 * sb(N) + max(rt * sa(L), l16 * sb(rt))),
    }


@pytest.mark.parametrize("case", range(6))
def test_backward_plan_matches_the_kernel_formulas_at_the_chip_cases(case):
    """``ssd_bwd_plan`` at each case that ``chip_smoke.py`` holds the
    kernel to (the model's, with h0 and dhT, ragged, Mamba2-2.7B's heads,
    bf16, odd widths): grids, threads and shared memory as the kernel
    computes them, within the card's limits."""
    cases = _chip_smoke().ssd_bwd_cases(torch)
    assert len(cases) == 6
    _, B, T, H, P, N, L, *_ = cases[case]
    plan = K.ssd_bwd_plan(B, T, H, P, N, L)
    c = -(-T // L)
    heads = K.bwd_heads(B, T, H, L)
    ng = -(-H // heads)
    assert 1 <= heads <= H and ng * c * B <= 132 or heads == 1
    assert plan["out_bwd"].grid == plan["states_bwd"].grid == (ng, c, B)
    assert plan["state_pass_bwd"].grid == (H, B, 1)
    assert plan["cb_bwd"].grid == (2 * -(-L // _cu_const("RT")), c, B)
    assert {k: p.smem for k, p in plan.items()} == _kernel_smem(L, P, N)
    big = _cu_const("BIG")
    assert [p.threads for p in plan.values()] == [big, 256, big, 256]
    for p in plan.values():
        assert p.smem <= 232_448


def test_backward_plans_fit_and_match_the_kernel():
    plan = K.ssd_bwd_plan(4, 512, 64, 64, 64, 128)
    assert K.bwd_heads(4, 512, 64, 128) == 8
    assert plan["out_bwd"].grid == plan["states_bwd"].grid == (8, 4, 4)
    assert plan["out_bwd"].smem == 4 * (128 * 136 + 3 * 128 * 72 + 17 * 128)
    assert K.ssd_bwd_plan(4, 512, 64, 64, 128, 128)["out_bwd"].smem == 4 * (
        128 * 72 + 2 * 128 * 136 + 128 * 72 + 17 * 128)
    assert plan["states_bwd"].smem == 4 * (128 * 68 + 2 * 128 * 72
                                           + 64 * 72 + 8 * 128)
    assert plan["cb_bwd"].grid == (16, 4, 4)
    assert plan["cb_bwd"].smem == 4 * (128 * 72 + 128 * 24)
    assert plan["state_pass_bwd"].grid == (64, 4, 1)
    for L, P, N in ((128, 64, 128), (128, 64, 64), (42, 18, 10)):
        for p in K.ssd_bwd_plan(2, 300, 4, P, N, L).values():
            assert p.smem <= 232_448 and p.threads in (256, 512)
    with pytest.raises(ValueError, match="SSD kernel limits"):
        K.ssd_bwd_plan(1, 16, 1, 65, 8, 16)
    assert _cu_const("RT") == K.RT_BWD
    assert _cu_const("NSMALL") == K.NSMALL_BWD
    assert _cu_const("BIG") == K.BIG
    text = (CSRC / "ssd_chunk_bwd.cu").read_text()
    for entry in ("ssd_out_bwd_launch", "ssd_state_pass_bwd_launch",
                  "ssd_states_bwd_launch", "ssd_cb_bwd_launch"):
        assert f'extern "C" int {entry}(' in text
    assert "atomicAdd" not in text  # fixed-order sums only
    # one copy of the 3xTF32 helpers, shared with the forward
    for src in ("ssd_chunk.cu", "ssd_chunk_bwd.cu"):
        body = (CSRC / src).read_text()
        assert '#include "ssd_common.cuh"' in body
        assert "void split(" not in body and "void mma_tf32(" not in body
