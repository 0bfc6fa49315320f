"""The grouped expert GEMM's tile schedule (``tile_schedule``, the Python
form of ``csrc/moe_grouped_gemm.cu``'s mapping from a block's linear tile
index to an expert, its rows and its first column): every output row and
column of every expert is written by exactly one tile, no tile reaches past
its expert's last row, and the blocks of a grid split the tiles between
them. CPU only."""

from __future__ import annotations

import numpy as np
import pytest

from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import TILE_ROWS, tile_schedule, tile_width


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64).tolist()


def _skewed(E, rows, seed):
    """``rows`` rows over ``E`` experts as the card tests draw them: cubed
    weights, three experts empty, one shorter than a tile."""
    rng = np.random.default_rng(seed)
    w = rng.random(E) ** 3
    w[[3, 17, 40]] = 0.0
    counts = np.floor(w / w.sum() * rows).astype(np.int64)
    counts[5] = 37
    counts[0] += rows - counts.sum()
    return _offsets(counts)


CASES = {
    "skewed_cell_widths": (_skewed(64, 20000, 0), 2816),
    "skewed_down": (_skewed(64, 6613, 1), 2048),
    "runs_mid_tile": (_offsets([5, 130, 0, 1, 257, 128, 0, 127]), 512),
    "empty_experts_between": (_offsets([0, 0, 300, 0, 0, 1, 0]), 256),
    "one_expert_all_rows": (_offsets([1000]), 2816),
    "one_expert_with_rows": (_offsets([0, 0, 0, 777, 0]), 1408 * 2),
    "all_empty": (_offsets([0, 0, 0]), 256),
    "narrow_tile": (_offsets([100, 0, 300]), 384),
}


def _owner(off):
    """Row -> expert of the runs [off[e], off[e + 1])."""
    owner = np.full(off[-1], -1, dtype=np.int64)
    for e in range(len(off) - 1):
        owner[off[e]:off[e + 1]] = e
    return owner


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_output_tile_is_written_once_within_its_expert(case, grid):
    off, n = CASES[case]
    bn = tile_width(n)
    owner = _owner(off)
    cover = np.zeros((off[-1], n // bn), dtype=np.int64)
    for block in range(grid):
        for e, row0, row1, n0 in tile_schedule(off, n, block, grid):
            assert off[e] <= row0 < row1 <= off[e + 1], (e, row0, row1)
            assert row1 - row0 <= TILE_ROWS and n0 % bn == 0 and 0 <= n0 < n
            assert (owner[row0:row1] == e).all()
            cover[row0:row1, n0 // bn] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocks_split_the_single_walk_in_its_order(case):
    """Block b of a grid of G walks tiles b, b + G, ... of the one walk,
    whose order is tiles of rows over the experts' runs, columns fastest."""
    off, n = CASES[case]
    walk = tile_schedule(off, n)
    n_cols = n // tile_width(n)
    for t in range(0, len(walk), n_cols):  # a tile of rows across all its columns
        assert len({(e, r0, r1) for e, r0, r1, _ in walk[t:t + n_cols]}) == 1
        assert [n0 for *_, n0 in walk[t:t + n_cols]] == sorted(n0 for *_, n0 in walk[t:t + n_cols])
    for grid in (2, 5, 132):
        for block in range(grid):
            assert tile_schedule(off, n, block, grid) == walk[block::grid]


def test_tile_width_adapts_to_n():
    assert [tile_width(n) for n in (2816, 2048, 384, 128, 256, 640)] == [256, 256, 128, 128,
                                                                          256, 128]


@pytest.mark.parametrize("seed", range(4))
def test_tiles_of_rows_stay_within_the_launch_bound(seed):
    """The launch sizes its grid from R / 128 + min(E, R) tiles of rows, which
    no offsets over R rows exceed."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(1, 80))
    R = int(rng.integers(1, 5000))
    counts = rng.multinomial(int(rng.integers(0, R + 1)), rng.dirichlet(np.full(E, 0.3)))
    off = _offsets(counts)
    rows = len(tile_schedule(off, 128))
    assert rows <= -(-R // TILE_ROWS) + min(E, R)
