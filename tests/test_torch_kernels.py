"""Plain versions of the port's kernels vs the JAX reference's kernels.

The reference side runs as its own tests run it on the CPU: the Pallas
kernels in interpret mode through ``repro.kernels.ops``.  The port side
runs its wrappers on CPU tensors, which take the plain PyTorch versions —
the same functions chip_smoke.py holds the CUDA kernels against on the
card.  Tolerances scale with the sum of magnitudes of the terms
(``|A| @ |X|``), never a fixed absolute value: decode matrices at k >= 12
carry entries of 1e4-1e5.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (as_np, assert_scaled_close, rounded, sum_coef,
                           to_j, to_t)
from repro.core.coding import vandermonde_generator
from repro.core.splitting import ConvSpec, plan_width_split
from repro.kernels import ops as jops
from repro.kernels.mds_encode import skinny_gemm_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.conv2d import conv2d as t_conv2d
from repro_torch.kernels.skinny_gemm import skinny_gemm as t_skinny_gemm

NK = [(3, 2), (10, 6), (16, 12), (16, 16)]
FS = [64, 512, 1000, 4097]
DTYPES = ["float32", "bfloat16"]


def _gemm_pair(A64, F, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rounded(A64, dtype)
    x = rounded(rng.normal(size=(A.shape[1], F)), dtype)
    return A, x


class TestMDSEncode:
    @pytest.mark.parametrize("n,k", NK)
    @pytest.mark.parametrize("F", FS)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_reference(self, n, k, F, dtype):
        G, x = _gemm_pair(vandermonde_generator(n, k), F, dtype, F + n)
        want = jops.mds_encode(to_j(G, dtype), to_j(x, dtype), interpret=True)
        got = tops.mds_encode(to_t(G, dtype), to_t(x, dtype))
        assert tuple(got.shape) == (n, F) and got.dtype == to_t(x, dtype).dtype
        assert_scaled_close(got, want, np.abs(G) @ np.abs(x),
                            sum_coef(k, dtype), "encode")
        oracle = tref.mds_encode_ref(to_t(G, dtype), to_t(x, dtype))
        assert torch.equal(got, oracle)  # CPU wrapper == plain version


class TestMDSDecode:
    @pytest.mark.parametrize("n,k", NK)
    @pytest.mark.parametrize("F", FS)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_reference(self, n, k, F, dtype):
        D64 = np.linalg.inv(vandermonde_generator(n, k)[:k])
        D, y = _gemm_pair(D64, F, dtype, F + n)
        want = jops.mds_decode(to_j(D, dtype), to_j(y, dtype), interpret=True)
        got = tops.mds_decode(to_t(D, dtype), to_t(y, dtype))
        assert tuple(got.shape) == (k, F)
        assert_scaled_close(got, want, np.abs(D) @ np.abs(y),
                            sum_coef(k, dtype), "decode")

    def test_encode_then_decode_roundtrip(self):
        """eq. 3 -> eq. 4 on subset [0,2,3,5,7,9] of (10, 6), both packages."""
        n, k, F = 10, 6, 777
        subset = [0, 2, 3, 5, 7, 9]
        G = vandermonde_generator(n, k)
        D = np.linalg.inv(G[subset])
        x = np.random.default_rng(0).normal(size=(k, F)).astype(np.float32)
        coded = tops.mds_encode(to_t(G), to_t(x))
        back = tops.mds_decode(to_t(D), coded[torch.tensor(subset)])
        j_coded = jops.mds_encode(to_j(G), to_j(x), interpret=True)
        j_back = jops.mds_decode(to_j(D), j_coded[np.asarray(subset)],
                                 interpret=True)
        # roundoff of the coded rows (|G||x| u) amplified by |D|
        scale = np.abs(D) @ (np.abs(G[subset]) @ np.abs(x))
        assert_scaled_close(back, x, scale, 4 * sum_coef(k), "roundtrip")
        assert_scaled_close(back, j_back, scale, 4 * sum_coef(k), "vs ref")


class TestPieceGemm:
    @pytest.mark.parametrize("m,b,F", [(37, 48, 80), (17, 5, 33), (5, 64, 7),
                                       (1, 300, 50), (16, 17, 130),
                                       (3, 1000, 9)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_reference(self, m, b, F, dtype):
        """Not both dims small: the executor's piece GEMM — the tiled regime
        (m > 16) and the split-K GEMV regime (m <= 16 < b)."""
        rng = np.random.default_rng(m * b)
        A = rounded(rng.normal(size=(m, b)) * b ** -0.5, dtype)
        x = rounded(rng.normal(size=(b, F)), dtype)
        want = skinny_gemm_pallas(to_j(A, dtype), to_j(x, dtype),
                                  interpret=True)
        got = t_skinny_gemm(to_t(A, dtype), to_t(x, dtype))
        assert_scaled_close(got, want, np.abs(A) @ np.abs(x),
                            sum_coef(b, dtype), "piece gemm")

    def test_a_is_cast_to_x_dtype(self):
        """bf16 data rounds the generator, as the reference does."""
        G = vandermonde_generator(10, 6)
        x = rounded(np.random.default_rng(1).normal(size=(6, 50)), "bfloat16")
        want = jops.mds_encode(to_j(G), to_j(x, "bfloat16"), interpret=True)
        got = t_skinny_gemm(to_t(G), to_t(x, "bfloat16"))
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got, want, np.abs(G) @ np.abs(x),
                            sum_coef(6, "bfloat16"), "cast")


CONV_SHAPES = [
    (3, 8, 12, 12, 3, 1),
    (16, 32, 14, 20, 3, 1),
    (8, 7, 11, 17, 5, 2),    # c_out not a block multiple
    (4, 64, 9, 9, 1, 1),     # 1x1
    (32, 16, 8, 30, 3, 2),
]


class TestConv2d:
    @pytest.mark.parametrize("ci,co,h,w,K,s", CONV_SHAPES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_reference(self, ci, co, h, w, K, s, dtype):
        rng = np.random.default_rng(ci * co)
        x = rounded(rng.normal(size=(ci, h, w)) * 0.5, dtype)
        wts = rounded(rng.normal(size=(co, ci, K, K)) * (ci * K * K) ** -0.5,
                      dtype)
        want = jops.conv2d_subtask(to_j(x, dtype), to_j(wts, dtype), s,
                                   interpret=True)
        got = tops.conv2d_subtask(to_t(x, dtype), to_t(wts, dtype), s)
        scale = as_np(tref.conv2d_ref(to_t(np.abs(x)), to_t(np.abs(wts)), s))
        assert_scaled_close(got, want, scale, sum_coef(ci * K * K, dtype),
                            "conv")
        assert torch.equal(got, tref.conv2d_ref(to_t(x, dtype),
                                                to_t(wts, dtype), s))

    @pytest.mark.parametrize("ci,co,h,w,K,s", CONV_SHAPES)
    def test_batched_equals_per_image(self, ci, co, h, w, K, s):
        """The port's kernel has the batch axis the Pallas kernel lacks:
        conv2d on (N, ...) is conv2d_subtask image by image."""
        rng = np.random.default_rng(co)
        x = to_t(rng.normal(size=(3, ci, h, w)))
        wts = to_t(rng.normal(size=(co, ci, K, K)))
        got = t_conv2d(x, wts, s)
        for i in range(3):
            want = jops.conv2d_subtask(to_j(x[i].numpy()), to_j(wts.numpy()),
                                       s, interpret=True)
            scale = as_np(tref.conv2d_ref(x[i].abs(), wts.abs(), s))
            assert_scaled_close(got[i], want, scale, sum_coef(ci * K * K),
                                "batched conv")

    def test_worker_subtask_equals_coded_pipeline_piece(self):
        """The kernel computes exactly one CoCoI worker's subtask, on a
        width slice read in place."""
        spec = ConvSpec(c_in=8, c_out=16, h_in=12, w_in=26, kernel=3, stride=1)
        plan = plan_width_split(spec, 3)
        rng = np.random.default_rng(0)
        x = to_t(rng.normal(size=(8, spec.h_in, spec.w_in)))
        w = to_t(rng.normal(size=(16, 8, 3, 3)) * 0.1)
        p = plan.parts[1]
        got = tops.conv2d_subtask(x[:, :, p.a_i:p.b_i], w, 1)
        whole = tref.conv2d_ref(x, w, 1)
        want = whole[:, :, p.a_o:p.b_o]
        scale = as_np(tref.conv2d_ref(x.abs(), w.abs(), 1))[:, :, p.a_o:p.b_o]
        assert_scaled_close(got, want, scale, sum_coef(72), "piece")
        j_piece = jops.conv2d_subtask(to_j(x[:, :, p.a_i:p.b_i].numpy()),
                                      to_j(w.numpy()), 1, interpret=True)
        assert_scaled_close(got, j_piece, scale, sum_coef(72), "piece vs ref")


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_and_count_no_launch(self):
        g0, c0 = t_skinny_gemm.launches, t_conv2d.launches
        t_skinny_gemm(torch.ones(2, 3), torch.ones(3, 5))
        t_conv2d(torch.ones(1, 2, 5, 5), torch.ones(3, 2, 3, 3))
        assert (t_skinny_gemm.launches, t_conv2d.launches) == (g0, c0)

    @pytest.mark.parametrize("A,X", [((2, 3), (4, 5)), ((2, 3, 1), (3, 5)),
                                     ((3,), (3, 5)), ((2, 0), (0, 5)),
                                     ((2, 3), (3, 0))])
    def test_skinny_gemm_rejects_bad_shapes(self, A, X):
        with pytest.raises(ValueError):
            t_skinny_gemm(torch.ones(A), torch.ones(X))

    @pytest.mark.parametrize("xs,ws,s", [
        ((2, 5, 5), (3, 2, 3, 3), 1),        # x not 4-D
        ((1, 2, 5, 5), (3, 4, 3, 3), 1),     # channels disagree
        ((1, 2, 5, 5), (3, 2, 3, 2), 1),     # kernel not square
        ((1, 2, 2, 5), (3, 2, 3, 3), 1),     # input smaller than kernel
        ((1, 2, 5, 5), (3, 2, 3, 3), 0),     # stride
        ((0, 2, 5, 5), (3, 2, 3, 3), 1),     # empty batch
    ])
    def test_conv2d_rejects_bad_shapes(self, xs, ws, s):
        with pytest.raises(ValueError):
            t_conv2d(torch.ones(xs), torch.ones(ws), s)

    def test_conv2d_rejects_mixed_dtypes(self):
        with pytest.raises(TypeError):
            t_conv2d(torch.ones(1, 2, 5, 5),
                     torch.ones(3, 2, 3, 3, dtype=torch.bfloat16))

    def test_conv2d_subtask_wants_one_image(self):
        with pytest.raises(ValueError):
            tops.conv2d_subtask(torch.ones(1, 2, 5, 5), torch.ones(3, 2, 3, 3))
