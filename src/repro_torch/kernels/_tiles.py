"""Launch plans of the hand-written GEMM-shaped kernels.

The skinny GEMM (``skinny_gemm.piece_plan``) and the direct conv
(``conv2d.conv_plan``) decide in Python how a launch is cut — regime, block
tile, contraction split, cluster size, shared memory — so that the CPU tests
can pin the rules; the C side (``csrc/sgemm_mainloop.cuh`` and the two
``.cu`` files) takes the plan and rejects one it cannot run.  ``TILES``
mirrors ``SGEMM_FOR_EACH_TILE`` in ``csrc/sgemm_mainloop.cuh``.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BK", "STAGES", "MAX_SPLIT", "SMEM_LIMIT", "N_SMS",
           "CODING_VARIANTS", "TILES", "LaunchPlan", "tile_threads",
           "tile_smem", "split_ranges", "pick_tile", "fill_note"]

BK = 16            # depth of one pipeline stage
STAGES = 4         # cp.async ring depth
APAD = 4           # padding of a K-major A row (floats)
MAX_SPLIT = 8      # the portable thread-block cluster size
SMEM_LIMIT = 232_448  # shared memory one block of an H100 may use
N_SMS = 132        # streaming multiprocessors of an H100 SXM
MIN_USED = 0.75  # least share of a grid's padded tiles that is real work

# the skinny GEMM's coding regime, by its C side's index (config)
CODING_VARIANTS = ("narrow", "scalar")

# (BM, BN, TM, TN): block tile and outputs per thread, largest first
TILES = ((128, 128, 8, 8), (128, 64, 8, 8), (64, 64, 4, 4), (32, 32, 4, 4))


@dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``regime`` is "coding", "gemv" or "tiled" (skinny GEMM)
    or "conv"; ``config`` the C side's index (tile index; GEMV log2 of the
    A rows held; coding the variant, ``CODING_VARIANTS``); ``tile`` (BM, BN,
    TM, TN), for GEMV (rows of A held, columns per block), for coding
    (columns per block, or per grid-stride step); ``splits`` the ascending
    ranges the contraction is cut into, one per cluster rank, each summed
    as one ascending chain and added in rank order; ``smem_bytes`` the dynamic
    shared memory and ``shared_bytes`` all of it; ``note`` says why the
    grid is smaller than the card when it is."""

    regime: str
    config: int
    tile: tuple
    threads: int
    splits: tuple
    grid: tuple
    smem_bytes: int
    shared_bytes: int
    note: str = ""

    @property
    def cluster(self) -> int:
        return len(self.splits)

    @property
    def chunk(self) -> int:
        return self.splits[0][1] - self.splits[0][0]

    @property
    def variant(self) -> str:
        """The coding regime's variant ("narrow" or "scalar")."""
        return CODING_VARIANTS[self.config] if self.regime == "coding" else ""

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def tile_threads(tile) -> int:
    bm, bn, tm, tn = tile
    return (bm // tm) * (bn // tn)


def tile_smem(tile) -> int:
    """Bytes of the ring: STAGES x (K-major A tile + B tile), f32."""
    bm, bn, _, _ = tile
    return STAGES * (BK * (bm + APAD) + BK * bn) * 4


def split_ranges(total: int, want: int, align: int = BK) -> tuple:
    """Cut ``range(total)`` into at most ``want`` (<= MAX_SPLIT) ascending
    ranges of one length, a multiple of ``align`` (the last may be short),
    none empty.  Depends on ``total`` and ``want`` only."""
    want = max(1, min(MAX_SPLIT, want))
    chunk = -(-total // want)
    chunk = -(-chunk // align) * align
    n = -(-total // chunk)
    return tuple((i * chunk, min(total, (i + 1) * chunk)) for i in range(n))


def pick_tile(rows: int, cols: int, n_splits: int, fill: int,
              first: int = 0) -> tuple[int, tuple]:
    """The first tile of ``TILES`` (largest first) that wastes at most a
    quarter of its padded work on the ragged edges and whose grid (times
    the split) reaches ``fill`` blocks; else, of those, the one that makes
    the most blocks.  Returns (index, (grid_x, grid_y)) with grid_x =
    column tiles x splits.  ``first`` skips the larger tiles.  (The
    callers' ``fill`` — two blocks per SM for the unsplit GEMM, about one
    for the split conv — was read off timings of every tile at the main
    paths' shapes on an H100.)"""
    best = None
    for i, (bm, bn, _, _) in enumerate(TILES):
        if i < first:
            continue
        gy, gx = -(-rows // bm), -(-cols // bn)
        used = rows * cols / (gy * bm * gx * bn)
        blocks = gx * gy * n_splits
        if used >= MIN_USED and blocks >= fill:
            return i, (gx * n_splits, gy)
        key = (used >= MIN_USED, blocks)
        if best is None or key > best[0]:
            best = (key, i, (gx * n_splits, gy))
    return best[1], best[2]


def fill_note(blocks: int, why: str) -> str:
    return "" if blocks >= N_SMS else f"{blocks} blocks < {N_SMS} SMs: {why}"
