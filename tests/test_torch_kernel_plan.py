"""Launch plans of the skinny GEMM and the direct conv (CPU only).

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there); how a launch is cut — regime, tile, contraction
split, cluster, shared memory — is decided in Python, and these tests pin
the rules the kernels' numerics rely on: the split of a contraction depends
on the contraction (and, for the conv, the weight) alone, so an output
element's reduction order never depends on F, N, H, W or P.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import _build, _tiles
from repro_torch.kernels.conv2d import conv_plan, conv_splits
from repro_torch.kernels import skinny_gemm as sg
from repro_torch.kernels.skinny_gemm import (SMALL, coding_plan,
                                             coding_variant_plan, gemv_splits,
                                             piece_plan, stacked_plan)

CSRC = Path(_build.__file__).resolve().parent / "csrc"
DTYPES = [torch.float32, torch.bfloat16]

# the main paths' shapes (PERF.md): Zamba2 pieces (t_p, d_in, d_out) and
# VGG16 (224, n=10, k=6) conv pieces at B = 1 and 4 (x shape, w shape)
GEMM_MAIN = [(1, 2048, 8192), (1, 8192, 2048), (682, 2048, 8192),
             (682, 8192, 2048), (133, 2048, 8192), (133, 8192, 2048)]
CONV_MAIN = [((b, ci, h, w), (co, ci, 3, 3))
             for b in (1, 4)
             for ci, h, w, co in [(128, 114, 20, 128), (128, 58, 11, 256),
                                  (256, 58, 11, 256), (256, 30, 6, 512),
                                  (512, 30, 6, 512), (512, 16, 4, 512)]]
CONV_LOCAL = [((1, 3, 226, 226), (64, 3, 3, 3)),
              ((1, 64, 226, 226), (64, 64, 3, 3)),
              ((1, 64, 114, 114), (128, 64, 3, 3))]

# the coding regime's products on the main paths (m, b, F): VGG16 (224,
# n=10, k=6) encodes at segment entry and decodes at exit at B = 1 and 4;
# Zamba2-1.2B's coded FFN (n=10, k=6) at prefill t_p = 682 and 133 and the
# decode step (t_p = 1), into w_in (2048 columns a token) and w_out (8192)
CODING_MAIN = [(10, 6, 291840), (10, 6, 4 * 291840), (10, 6, 32768),
               (10, 6, 4 * 32768), (6, 6, 258048), (6, 6, 4 * 258048),
               (6, 6, 14336), (6, 6, 4 * 14336)] + [
    (m, 6, t_p * d) for t_p in (682, 133, 1) for d in (2048, 8192)
    for m in (10, 6)]

dims = st.integers(min_value=1, max_value=20000)


def _assert_partition(splits, total):
    assert 1 <= len(splits) <= _tiles.MAX_SPLIT
    assert splits[0][0] == 0 and splits[-1][1] == total
    for (a0, a1), (b0, _) in zip(splits, splits[1:]):
        assert a1 == b0
    assert all(a < b for a, b in splits)  # ascending, none empty
    # one length for every range but the last (the C side takes a chunk)
    chunk = splits[0][1] - splits[0][0]
    assert all(b - a == chunk for a, b in splits[:-1])
    assert splits[-1][1] - splits[-1][0] <= chunk


def _assert_plan_fits(plan):
    assert plan.cluster <= _tiles.MAX_SPLIT
    assert plan.shared_bytes <= _tiles.SMEM_LIMIT
    if plan.smem_bytes == 0:  # static shared memory only
        assert plan.shared_bytes <= 48 * 1024
    assert plan.threads <= 1024 and plan.grid[1] <= 65535


class TestPiecePlan:
    @settings(max_examples=200, deadline=None)
    @given(m=dims, b=dims, F1=dims, F2=dims,
           dtype=st.sampled_from(DTYPES))
    def test_split_depends_on_regime_and_b_only(self, m, b, F1, F2, dtype):
        p1, p2 = piece_plan(m, b, F1, dtype), piece_plan(m, b, F2, dtype)
        assert p1.regime == p2.regime
        assert p1.splits == p2.splits
        _assert_partition(p1.splits, b)
        _assert_plan_fits(p1)
        _assert_plan_fits(p2)

    @settings(max_examples=200, deadline=None)
    @given(m=dims, b=dims, F=dims, dtype=st.sampled_from(DTYPES))
    def test_grid_covers_the_output(self, m, b, F, dtype):
        p = piece_plan(m, b, F, dtype)
        if p.regime == "tiled":
            bm, bn, _, _ = p.tile
            assert p.splits == ((0, b),)  # one ascending chain per output
            assert p.grid[0] * bn >= F and p.grid[1] * bm >= m
            assert (p.grid[0] - 1) * bn < F and (p.grid[1] - 1) * bm < m
            assert p.smem_bytes == _tiles.tile_smem(p.tile)
            assert p.threads == _tiles.tile_threads(p.tile)
        elif p.regime == "gemv":
            mr, width = p.tile
            assert m <= mr <= 16 and mr == 1 << (m - 1).bit_length()
            assert p.config == mr.bit_length() - 1
            assert p.grid[0] == -(-F // width) * p.cluster
            assert p.splits == gemv_splits(b)
        else:
            assert m <= 16 and b <= 16 and p.splits == ((0, b),)

    @pytest.mark.parametrize("m,b,regime", [
        (16, 16, "coding"), (1, 16, "coding"), (16, 17, "gemv"),
        (1, 8192, "gemv"), (17, 16, "tiled"), (17, 17, "tiled"),
        (682, 2048, "tiled")])
    def test_regime_boundaries(self, m, b, regime):
        assert piece_plan(m, b, 100).regime == regime

    @pytest.mark.parametrize("m,b,F", GEMM_MAIN)
    def test_main_path_shapes_fill_the_card_or_say_why(self, m, b, F):
        p = piece_plan(m, b, F)
        if p.blocks >= _tiles.N_SMS:
            assert p.note == ""
        else:  # the GEMV regime streams bytes: one wide slab a block
            assert p.regime == "gemv" and "SMs" in p.note

    def test_small_grid_says_why(self):
        p = piece_plan(37, 48, 80)
        assert p.blocks < _tiles.N_SMS and "SMs" in p.note

    @pytest.mark.parametrize("b,n", [(17, 1), (1024, 1), (2048, 2),
                                     (8191, 8), (8192, 8), (65536, 8)])
    def test_gemv_split_counts(self, b, n):
        assert len(gemv_splits(b)) == n
        _assert_partition(gemv_splits(b), b)

    def test_rejects_an_empty_product(self):
        with pytest.raises(ValueError):
            piece_plan(0, 4, 4)


def coding_tiles(plan, F: int) -> np.ndarray:
    """The column tiles a coding plan's blocks walk, as
    ``csrc/skinny_gemm.cu`` cuts them: rows ``(block, first column, end
    column)``."""
    gx, cols = plan.grid[0], plan.tile[0]
    if plan.variant == "narrow":
        out = [(x, x * cols, min((x + 1) * cols, F)) for x in range(gx)]
    else:  # scalar: grid-stride
        out = [(x, c, min(c + cols, F)) for x in range(gx)
               for c in range(x * cols, F, gx * cols)]
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _assert_coding_walk(plan, F):
    """The tiles of a coding plan cover every column exactly once, none
    wider than the plan's tile."""
    tiles = coding_tiles(plan, F)
    assert tiles[:, 0].min() == 0 and tiles[:, 0].max() == plan.grid[0] - 1
    cover = np.zeros(F + 1, np.int64)
    np.add.at(cover, tiles[:, 1], 1)
    np.add.at(cover, tiles[:, 2], -1)
    assert (np.cumsum(cover)[:F] == 1).all()
    assert (tiles[:, 2] > tiles[:, 1]).all()
    assert (tiles[:, 2] - tiles[:, 1]).max() <= plan.tile[0]


def _assert_coding_grid(plan, F, dtype):
    """Grid: narrow one block a tile of whole 16-byte groups; scalar
    grid-stride, at most 65536 blocks.  No dynamic shared memory."""
    V = 16 // torch.empty((), dtype=dtype).element_size()
    gx = plan.grid[0]
    if plan.variant == "narrow":
        assert F % V == 0 and gx == -(-F // plan.tile[0])
        assert plan.tile == (plan.threads * V,)
    else:
        assert plan.variant == "scalar"
        assert gx == min(-(-F // plan.threads), sg.SCALAR_MAX_BLOCKS)
        assert plan.tile == (plan.threads,)
    assert plan.smem_bytes == 0 and plan.shared_bytes <= _tiles.SMEM_LIMIT


class TestCodingPlan:
    """The coding regime (m, b <= 16): which variant runs each product, and
    that its grid covers the output once.  Every variant computes an output
    as one ascending fmaf chain over b, so the choice never moves a bit."""

    @pytest.mark.parametrize("m,b,F", CODING_MAIN)
    def test_main_path_shapes_take_narrow(self, m, b, F):
        p = coding_plan(m, b, F)
        assert p.regime == "coding" and p.variant == "narrow"
        assert p == piece_plan(m, b, F)
        _assert_coding_grid(p, F, torch.float32)
        _assert_coding_walk(p, F)

    @pytest.mark.parametrize("m,b,F,dtype,aligned,variant", [
        (10, 6, 291843, torch.float32, True, "scalar"),  # ragged
        (10, 6, 2 ** 21 - 1, torch.float32, True, "scalar"),
        (10, 6, 2 ** 21 + 1, torch.float32, True, "scalar"),
        (6, 6, 682 * 8192 + 1, torch.float32, True, "scalar"),
        (16, 16, 4097, torch.float32, True, "scalar"),
        (10, 6, 2 ** 21 + 1, torch.bfloat16, True, "scalar"),
        (10, 6, 291840, torch.bfloat16, True, "narrow"),
        (10, 6, 682 * 8192, torch.bfloat16, True, "narrow"),
        (10, 6, 291840, torch.float32, False, "scalar"),  # unaligned X
        (10, 6, 682 * 8192, torch.float32, False, "scalar"),
        (16, 16, 262144, torch.float32, True, "narrow")])
    def test_edges(self, m, b, F, dtype, aligned, variant):
        p = coding_plan(m, b, F, dtype, aligned)
        assert p.variant == variant
        assert p == piece_plan(m, b, F, dtype, aligned)
        _assert_coding_grid(p, F, dtype)
        _assert_coding_walk(p, F)

    @settings(max_examples=150, deadline=None)
    @given(b=st.integers(1, 16), F=st.integers(1, 300000),
           dtype=st.sampled_from(DTYPES), aligned=st.booleans(),
           variant=st.sampled_from(_tiles.CODING_VARIANTS))
    def test_every_variant_covers_the_output_once(self, b, F, dtype, aligned,
                                                  variant):
        p = coding_plan(1, b, F, dtype, aligned)
        assert p == coding_plan(16, b, F, dtype, aligned)  # m is not read
        _assert_coding_grid(p, F, dtype)
        _assert_coding_walk(p, F)
        V = 16 // torch.empty((), dtype=dtype).element_size()
        if variant == "narrow" and F % V:
            with pytest.raises(ValueError):
                coding_variant_plan(variant, b, F, dtype)
            return
        q = coding_variant_plan(variant, b, F, dtype)
        _assert_coding_grid(q, F, dtype)
        _assert_coding_walk(q, F)

    @pytest.mark.parametrize("plan,args", [
        (piece_plan, (10, 6, 291840)), (piece_plan, (1, 2048, 8192)),
        (stacked_plan, (10, 1, 6, 2048)), (stacked_plan, (10, 682, 2048,
                                                          8192))])
    def test_plans_are_made_once_per_shape(self, plan, args):
        """A launch looks its plan up: every encode, decode and piece of a
        ``generate`` asks again for one of a few shapes."""
        assert plan(*args) is plan(*args)
        assert plan(*args, torch.float32, False) is plan(*args,
                                                         torch.float32, False)

    @pytest.mark.parametrize("n,t_p,F,groups", [(10, 1, 2048, 1),
                                                (3, 10, 8192, 2),
                                                (10, 4, 682 * 8192, 3)])
    def test_stacked_row_groups(self, n, t_p, F, groups):
        p = stacked_plan(n, t_p, 6, F)
        assert p.regime == "coding" and p.variant == "narrow"
        assert p.grid == (coding_plan(16, 6, F).grid[0], groups)

    def test_rejects_what_is_not_a_coding_product(self):
        with pytest.raises(ValueError):
            coding_plan(17, 6, 64)
        with pytest.raises(ValueError):
            coding_plan(6, 17, 64)
        with pytest.raises(ValueError):
            coding_variant_plan("vector", 6, 64)


class TestStackedPlan:
    """``piece_gemm_stacked``: n pieces of t_p rows in one launch, in the
    regime one piece takes (chosen by t_p, never by n * t_p), so a row's
    reduction order — and its bits — are its piece's."""

    @settings(max_examples=200, deadline=None)
    @given(n=st.integers(1, 16), t_p=st.integers(1, 40), b=dims, F=dims,
           dtype=st.sampled_from(DTYPES))
    def test_regime_and_split_are_one_pieces(self, n, t_p, b, F, dtype):
        p, one = stacked_plan(n, t_p, b, F, dtype), piece_plan(t_p, b, F,
                                                                dtype)
        assert p.regime == one.regime
        assert p.splits == one.splits
        _assert_plan_fits(p)
        rows = n * t_p
        if p.regime == "tiled":
            assert p == piece_plan(rows, b, F, dtype)  # the whole stack
            return
        # row groups on grid.y: 16 rows (GEMV: MR, 16 once the stack is
        # taller than 16), the last one ragged; the column slabs and
        # cluster of one row group are one piece's
        group = SMALL if p.regime == "coding" else p.tile[0]
        assert (p.grid[1] - 1) * group < rows <= p.grid[1] * group
        assert p.grid[0] == one.grid[0]
        if p.regime == "gemv":
            assert p.tile[0] == 1 << (min(rows, SMALL) - 1).bit_length()
            assert p.config == p.tile[0].bit_length() - 1

    @pytest.mark.parametrize("n,t_p,b,regime,groups,mr", [
        (10, 1, 2048, "gemv", 1, 16),    # a decode step: one GEMV, m = 10
        (10, 1, 8192, "gemv", 1, 16),
        (10, 2, 2048, "gemv", 2, 16),    # 20 rows: two row groups
        (10, 16, 8192, "gemv", 10, 16),  # the regime's edge
        (3, 2, 2048, "gemv", 1, 8),      # a short stack keeps its MR
        (10, 4, 8, "coding", 3, None),   # b <= 16: the coding regime
        (10, 17, 2048, "tiled", None, None),  # t_p = 17: tiled stack
        (10, 133, 2048, "tiled", None, None),
        (10, 682, 8192, "tiled", None, None)])
    def test_main_path_and_edges(self, n, t_p, b, regime, groups, mr):
        p = stacked_plan(n, t_p, b, 8192)
        assert p.regime == regime
        if regime == "tiled":
            assert p.grid == piece_plan(n * t_p, b, 8192).grid
            return
        assert p.grid[1] == groups
        if mr is not None:
            assert p.tile[0] == mr

    def test_edge_between_regimes(self):
        assert stacked_plan(10, 16, 2048, 64).regime == "gemv"
        assert stacked_plan(10, 17, 2048, 64).regime == "tiled"
        assert stacked_plan(1, 16, 16, 64).regime == "coding"
        assert stacked_plan(1, 17, 16, 64).regime == "tiled"

    def test_rejects_an_empty_stack(self):
        with pytest.raises(ValueError):
            stacked_plan(0, 1, 4, 4)
        with pytest.raises(ValueError):
            stacked_plan(2, 0, 4, 4)


conv_x = st.tuples(st.integers(1, 12), st.integers(1, 40),
                   st.integers(1, 40))
conv_w = st.tuples(st.integers(1, 600), st.integers(1, 600),
                   st.sampled_from([1, 3, 5, 7]))


class TestConvPlan:
    @settings(max_examples=200, deadline=None)
    @given(w=conv_w, x1=conv_x, x2=conv_x, stride=st.sampled_from([1, 2]))
    def test_split_depends_on_the_weight_only(self, w, x1, x2, stride):
        c_out, c_in, K = w
        ws = (c_out, c_in, K, K)
        plans = [conv_plan((n, c_in, h + K, wd + K), ws, stride)
                 for n, h, wd in (x1, x2)]
        assert plans[0].splits == plans[1].splits == conv_splits(ws)
        _assert_partition(plans[0].splits, c_in * K * K)
        for p in plans:
            _assert_plan_fits(p)
            chunk = p.splits[0][1] - p.splits[0][0]
            assert p.smem_bytes == _tiles.tile_smem(p.tile) + 4 * chunk

    @settings(max_examples=100, deadline=None)
    @given(w=conv_w, x=conv_x, stride=st.sampled_from([1, 2]))
    def test_grid_covers_the_output(self, w, x, stride):
        c_out, c_in, K = w
        n, h, wd = x
        p = conv_plan((n, c_in, h + K, wd + K), (c_out, c_in, K, K), stride)
        P = n * (h // stride + 1) * (wd // stride + 1)
        bm, bn, _, _ = p.tile
        assert p.grid[0] == -(-P // bn) * p.cluster
        assert p.grid[1] == -(-c_out // bm)
        assert p.threads == _tiles.tile_threads(p.tile)

    @pytest.mark.parametrize("xs,ws", CONV_MAIN + CONV_LOCAL)
    def test_main_path_shapes_fill_the_card_or_say_why(self, xs, ws):
        p = conv_plan(xs, ws, 1)
        if p.blocks >= _tiles.N_SMS:
            assert p.note == ""
        else:
            assert "SMs" in p.note and f"split {p.cluster} ways" in p.note

    @pytest.mark.parametrize("ws,n", [((64, 3, 3, 3), 1), ((64, 64, 3, 3), 1),
                                      ((128, 64, 3, 3), 1),
                                      ((128, 128, 3, 3), 2),
                                      ((256, 256, 3, 3), 2),
                                      ((512, 256, 3, 3), 8),
                                      ((512, 512, 3, 3), 8)])
    def test_vgg16_split_counts(self, ws, n):
        assert len(conv_splits(ws)) == n

    def test_folded_pieces_share_the_pieces_split(self):
        """The functional path folds n pieces into N; the pool launches
        them one by one: same weight, so the same split and order."""
        ws = (512, 512, 3, 3)
        one, folded = conv_plan((1, 512, 30, 6), ws), conv_plan(
            (10, 512, 30, 6), ws)
        assert one.splits == folded.splits


class TestSourcesAgree:
    """The Python plans mirror constants of the CUDA sources."""

    def test_tile_table(self):
        text = (CSRC / "sgemm_mainloop.cuh").read_text()
        rows = re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", text)
        assert [int(r[0]) for r in rows] == list(range(len(_tiles.TILES)))
        assert tuple(tuple(int(v) for v in r[1:]) for r in rows) == \
            _tiles.TILES

    @pytest.mark.parametrize("name,value", [("BK", _tiles.BK),
                                            ("STAGES", _tiles.STAGES),
                                            ("APAD", _tiles.APAD),
                                            ("MAX_SPLIT", _tiles.MAX_SPLIT)])
    def test_mainloop_constants(self, name, value):
        text = (CSRC / "sgemm_mainloop.cuh").read_text()
        assert re.search(rf"constexpr int {name} = (\d+);", text).group(1) \
            == str(value)

    def test_gemv_constants(self):
        from repro_torch.kernels import skinny_gemm as sg
        text = (CSRC / "skinny_gemm.cu").read_text()
        for name in ("GEMV_THREADS", "GEMV_GROUPS"):
            got = re.search(rf"constexpr int {name} = (\d+);", text).group(1)
            assert int(got) == getattr(sg, name)

    def test_coding_constants(self):
        text = (CSRC / "skinny_gemm.cu").read_text()
        for name in ("NARROW_THREADS", "SCALAR_THREADS"):
            got = re.search(rf"constexpr int {name} = (\d+);", text).group(1)
            assert int(got) == getattr(sg, name)
        enum = re.search(r"enum CodingVariant \{([^}]*)\}", text).group(1)
        names = [e.split("=")[0].strip().lower() for e in enum.split(",")]
        assert tuple(names) == _tiles.CODING_VARIANTS

    def test_row_groups(self):
        """The coding regime's row group is the C side's MAX_SMALL rows,
        and the entry point takes the row-group count."""
        text = (CSRC / "skinny_gemm.cu").read_text()
        got = re.search(r"constexpr int MAX_SMALL = (\d+);", text).group(1)
        assert int(got) == SMALL
        entry = text[text.index('extern "C" int skinny_gemm_launch'):]
        assert "int groups" in entry[:entry.index(")")]


def test_build_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited .cuh renames every library, so a stale build is never
    loaded; nothing is compiled here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.SOURCES:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    hdr = csrc / "shared.cuh"
    hdr.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = {n: _build._target(n)[1].name for n in _build.SOURCES}
    hdr.write_text("// two\n")
    after = {n: _build._target(n)[1].name for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    (csrc / "more.cuh").write_text("// a new header\n")
    assert all(_build._target(n)[1].name != after[n] for n in _build.SOURCES)
    assert not (tmp_path / "build").exists()  # naming builds nothing
