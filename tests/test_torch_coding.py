"""Codes and schemes of the port vs the JAX reference.

Host-side matrices (Vandermonde generators, decode matrices, LT rows and LT
pseudo-inverses) must EQUAL the reference's bit for bit — they are the same
numpy code.  ``encode``/``decode_from`` run the skinny GEMM's plain version
here and are held to the reference with a tolerance that scales with
``|D| @ |y|``.  Selection schemes (replication, uncoded) gather, so they are
exact and keep ``-0.0``.
"""
import itertools

import numpy as np
import pytest
import torch

from _torch_parity import (U32, as_np, assert_scaled_close, make_scheme,
                           sum_coef, to_j, to_t)
from repro.core import coding as jcoding
from repro.core import schemes as jschemes
from repro_torch.core import coding as tcoding
from repro_torch.core import schemes as tschemes

NAMES = ["lt", "mds", "replication", "uncoded"]


def test_registry_matches_reference():
    assert tschemes.scheme_names() == jschemes.scheme_names() == NAMES
    assert tschemes.get_scheme("coded") is tschemes.MDSScheme
    for name in NAMES:
        assert (tschemes.commutes_elementwise(name)
                == jschemes.commutes_elementwise(name))
    with pytest.raises(ValueError, match="unknown coding scheme"):
        tschemes.get_scheme("nope")


@pytest.mark.parametrize("kind", ["chebyshev", "integer"])
@pytest.mark.parametrize("n,k", [(1, 1), (3, 2), (5, 3), (10, 6), (16, 12),
                                 (16, 16)])
def test_generator_equals_reference(n, k, kind):
    G = tcoding.vandermonde_generator(n, k, kind)
    assert G.dtype == np.float64 and not G.flags.writeable
    assert np.array_equal(G, jcoding.vandermonde_generator(n, k, kind))
    assert np.array_equal(tcoding.vandermonde_nodes(n, kind),
                          jcoding.vandermonde_nodes(n, kind))


@pytest.mark.parametrize("n,k", [(3, 2), (5, 3), (10, 6), (16, 12)])
def test_decode_matrix_equals_reference(n, k):
    rng = np.random.default_rng(n * k)
    for _ in range(6):
        sub = tuple(int(i) for i in rng.permutation(n)[:k])
        D = tcoding.decode_matrix_cached(n, k, sub, "chebyshev")
        assert np.array_equal(
            D, jcoding.decode_matrix_cached(n, k, sub, "chebyshev"))
        assert np.array_equal(tcoding.MDSCode(n, k).decode_matrix(sub),
                              jcoding.MDSCode(n, k).decode_matrix(sub))


@pytest.mark.parametrize("k", [1, 2, 5, 8, 16])
def test_robust_soliton_equals_reference(k):
    assert np.array_equal(tcoding.robust_soliton(k), jcoding.robust_soliton(k))


@pytest.mark.parametrize("n,k,seed", [(6, 3, 0), (8, 4, 1), (10, 6, 0),
                                      (12, 7, 5)])
def test_lt_rows_and_decode_matrices_equal_reference(n, k, seed):
    t = tschemes.LTScheme.make(n, k, seed=seed)
    j = jschemes.LTScheme.make(n, k, seed=seed)
    assert (t.n, t.k, t.seed) == (j.n, j.k, j.seed)
    assert np.array_equal(t.rows, j.rows)
    assert t.default_subset() == j.default_subset()
    assert t.encode_flops(10) == j.encode_flops(10)
    sub = tuple(t.default_subset())
    assert np.array_equal(
        tschemes._lt_decode_matrix(t.n, t.k, t.seed, t.c, t.delta, sub),
        jschemes._lt_decode_matrix(j.n, j.k, j.seed, j.c, j.delta, sub))
    # rateless extension keeps the prefix, as the reference's does
    assert np.array_equal(t.extend(3).rows, j.extend(3).rows)
    assert np.array_equal(t.extend(3).rows[:n], t.rows)
    assert tschemes.lt_overhead_samples(k, trials=20) == \
        jschemes.lt_overhead_samples(k, trials=20)


def _decodable_subsets(scheme, limit=40):
    """Decodable subsets of every size from min_done up, in a fixed order
    (and one of them shuffled, since arrival order is arbitrary)."""
    out = []
    for m in range(scheme.min_done, scheme.n + 1):
        for sub in itertools.combinations(range(scheme.n), m):
            if scheme.decodable(list(sub)):
                out.append(list(sub))
    out = out[:limit]
    if out:
        out.append(list(reversed(out[0])))
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", [(4, 2), (5, 3), (6, 4)])
def test_roundtrip_on_every_decodable_subset(name, n, k):
    scheme = make_scheme(tschemes, name, n, k)
    ref = make_scheme(jschemes, name, n, k)
    assert (scheme.n, scheme.k) == (ref.n, ref.k)
    x = np.random.default_rng(n + k).normal(size=(scheme.k, 37)).astype(
        np.float32)
    coded = scheme.encode(to_t(x))
    assert tuple(coded.shape) == (scheme.n, 37)
    subsets = _decodable_subsets(scheme)
    assert subsets and subsets == _decodable_subsets(ref)
    for sub in subsets:
        back = scheme.decode_from(sub, coded[torch.tensor(sub)])
        if tschemes.commutes_elementwise(scheme):
            assert np.array_equal(as_np(back), x), sub  # a gather: exact
            continue
        if hasattr(scheme, "decode_matrix"):
            keep = sub[: scheme.k]
            D, y = scheme.decode_matrix(keep), as_np(coded)[keep]
        else:
            D = np.linalg.pinv(scheme.rows[sub])
            y = as_np(coded)[sub]
        # coded rows carry roundoff u |G||x| <= u |y|-ish; the decode sums
        # |D| @ |y|: the tolerance follows that product, not a constant
        assert_scaled_close(back, x, np.abs(D) @ np.abs(y),
                            8 * sum_coef(scheme.k), f"{name} {sub}")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,k", [(4, 2), (6, 4), (10, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_match_reference(name, n, k, dtype):
    from _torch_parity import rounded

    scheme = make_scheme(tschemes, name, n, k)
    ref = make_scheme(jschemes, name, n, k)
    x = rounded(np.random.default_rng(7).normal(size=(scheme.k, 130)), dtype)
    got = scheme.encode(to_t(x, dtype))
    want = ref.encode(to_j(x, dtype))
    G = (scheme.generator if hasattr(scheme, "generator")
         else getattr(scheme, "rows", None))
    if G is None:
        assert np.array_equal(as_np(got), as_np(want))
    else:
        # bf16: each side rounds the generator itself, so allow its rounding
        extra = 2.0 ** -8 if dtype == "bfloat16" else 0.0
        assert_scaled_close(got, want, np.abs(G) @ np.abs(x),
                            sum_coef(scheme.k, dtype) + extra, "encode")
    sub = scheme.default_subset()
    assert sub == ref.default_subset()
    y = as_np(want)[sub]                        # identical coded input
    got_d = scheme.decode_from(sub, to_t(y, dtype))
    want_d = ref.decode_from(sub, to_j(y, dtype))
    if G is None:
        assert np.array_equal(as_np(got_d), as_np(want_d))
    else:
        D = (scheme.decode_matrix(sub) if hasattr(scheme, "decode_matrix")
             else np.linalg.pinv(scheme.rows[sub]))
        extra = 2.0 ** -8 if dtype == "bfloat16" else 0.0
        assert_scaled_close(got_d, want_d, np.abs(D) @ np.abs(y),
                            sum_coef(len(sub), dtype) + extra, "decode")


@pytest.mark.parametrize("name", ["replication", "uncoded"])
def test_selection_schemes_keep_negative_zero(name):
    scheme = make_scheme(tschemes, name, 6, 3)
    x = torch.zeros(scheme.k, 4)
    x[:, 1] = -0.0
    x[:, 2] = 1.5
    coded = scheme.encode(x)
    back = scheme.decode_from(scheme.default_subset(),
                              coded[torch.tensor(scheme.default_subset())])
    for t in (coded, back):
        assert torch.signbit(t[:, 1]).all() and not torch.signbit(t[:, 0]).any()
    assert torch.equal(back, x)


@pytest.mark.parametrize("name", NAMES)
def test_decode_blocks_chunked_equals_one_shot(name):
    scheme = make_scheme(tschemes, name, 6, 4)
    ref = make_scheme(jschemes, name, 6, 4)
    rng = np.random.default_rng(3)
    sub = scheme.default_subset()
    stacked = rng.normal(size=(len(sub), 2, 3, 5, 11)).astype(np.float32)
    one = tschemes.decode_blocks(scheme, sub, to_t(stacked))
    for chunks in (2, 3, 11, 50):
        blk = tschemes.decode_blocks(scheme, sub, to_t(stacked), chunks=chunks)
        assert torch.equal(blk, one), chunks   # same reductions, bit for bit
    want = jschemes.decode_blocks(ref, sub, to_j(stacked), chunks=3)
    amp = np.abs(stacked).max() * 64
    assert_scaled_close(one, want, amp, 64 * U32, "decode_blocks vs ref")
    assert tschemes.chunk_bounds(11, 3) == jschemes.chunk_bounds(11, 3)


def test_mds_decode_downselects_long_subsets_like_reference():
    t, j = tcoding.MDSCode(6, 3), jcoding.MDSCode(6, 3)
    x = np.random.default_rng(5).normal(size=(3, 20)).astype(np.float32)
    coded = as_np(j.encode(to_j(x)))
    sub = [4, 4, 1, 5, 0, 2]          # duplicates and more than k rows
    got = t.decode_from(sub, to_t(coded[sub]))
    want = j.decode_from(sub, to_j(coded[sub]))
    D = t.decode_matrix([4, 1, 5])
    assert_scaled_close(got, want, np.abs(D) @ np.abs(coded[[4, 1, 5]]),
                        sum_coef(3), "downselect")
    assert t.decodable(sub) and not t.decodable([1, 1, 1])
    with pytest.raises(ValueError):
        t.decode_matrix([0, 1])
    with pytest.raises(ValueError):
        t.encode(torch.zeros(2, 4))


def test_lt_code_lstsq_matches_reference():
    code_t, code_j = tcoding.LTCode(4), jcoding.LTCode(4)
    rows = code_t.sample_encoding_matrix(9, seed=2)
    assert np.array_equal(rows, code_j.sample_encoding_matrix(9, seed=2))
    assert tcoding.LTCode.decodable(rows, 4)
    x = np.random.default_rng(2).normal(size=(4, 15)).astype(np.float32)
    coded_t = tcoding.LTCode.encode_with(rows, to_t(x))
    coded_j = jcoding.LTCode.encode_with(rows, to_j(x))
    assert_scaled_close(coded_t, coded_j, rows @ np.abs(x), sum_coef(4), "enc")
    got = tcoding.LTCode.decode_from(rows, coded_t)
    want = jcoding.LTCode.decode_from(rows, coded_j)
    scale = np.abs(np.linalg.pinv(rows)) @ np.abs(as_np(coded_t))
    assert_scaled_close(got, x, scale, 64 * U32, "lstsq roundtrip")
    assert_scaled_close(got, want, scale, 64 * U32, "lstsq vs ref")


def test_resolve_subset_and_source_of_piece_match_reference():
    for name in NAMES:
        t, j = make_scheme(tschemes, name, 6, 3), make_scheme(jschemes, name, 6, 3)
        assert tschemes.resolve_subset(t, None) == jschemes.resolve_subset(j, None)
        assert ([tschemes.source_of_piece(t, i) for i in range(t.n)]
                == [jschemes.source_of_piece(j, i) for i in range(j.n)])
        assert (t.min_done, t.r) == (j.min_done, j.r)
        assert t.encode_flops(100) == j.encode_flops(100)
        assert t.decode_flops(100) == j.decode_flops(100)
    with pytest.raises(ValueError, match="not decodable"):
        tschemes.resolve_subset(tschemes.MDSScheme(5, 3), [0, 1])
    assert tschemes.warm_decode_cache(tschemes.MDSScheme(5, 3), limit=4) == 4


def test_device_matrices_are_uploaded_once():
    key = ("test_once", 1)
    calls = []

    def make():
        calls.append(1)
        return np.eye(2)

    a = tcoding.device_matrix(key, make, torch.float32, torch.device("cpu"))
    b = tcoding.device_matrix(key, make, torch.float32, torch.device("cpu"))
    c = tcoding.device_matrix(key, make, torch.bfloat16, torch.device("cpu"))
    assert a is b and len(calls) == 2 and c.dtype == torch.bfloat16
    idx = tcoding.device_index([2, 0, 1], torch.device("cpu"))
    assert idx.dtype == torch.int64 and idx.tolist() == [2, 0, 1]
    assert idx is tcoding.device_index((2, 0, 1), torch.device("cpu"))


def test_device_matrix_cache_under_threads():
    """Worker threads share the upload cache: every lookup, from any thread
    and under a short switch interval, returns the right matrix."""
    import sys
    import threading

    want = tcoding.vandermonde_generator(10, 6).astype(np.float32)
    bad, old = [], sys.getswitchinterval()

    def work(seed):
        for i in range(200):
            key = ("stress", (seed + i) % 7)
            t = tcoding.device_matrix(
                key, lambda: tcoding.vandermonde_generator(10, 6),
                torch.float32, torch.device("cpu"))
            if not np.array_equal(t.numpy(), want):
                bad.append(key)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not bad
