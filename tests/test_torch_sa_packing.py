"""CPU: the SA MLP kernels' row packing (csrc/sa.cu: mma.sync's blocks and
16-row tiles, wgmma's work items and 64-row tiles, the CUDA-core kernel's
128-row tiles) and a model of the wgmma kernel's max-pool over a tile
(pool_rows and pool_half).

Every packed row lands in exactly one tile, and each centroid's max-pool
covers exactly its own rows, at random counts in 0..128 (and beyond, which
the kernels clip to 128)."""

import numpy as np
import pytest

from mpinets_torch.kernels import ops


def packed_tiles(count, cpb, tile_rows):
    """The rows of one batch row's SA MLP as the kernels pack them: the
    centroids in blocks (``wgmma``: work items) of ``cpb``, centroid g of
    one owning max(min(count, 128), 1) rows from the exclusive prefix of
    those counts, and tiles of ``tile_rows`` rows over the concatenation.
    ``count`` [S], the kept counts. -> one list a block, of tiles, of
    (centroid, slot) a row: slot j the j-th kept neighbour, -1 the zero raw
    row of a centroid without any; (-1, -1) past the block's rows."""
    count = [int(k) for k in count]
    blocks = []
    for s0 in range(0, len(count), cpb):
        rows = [(s, j if j < k else -1) for s, k in enumerate(count[s0:s0 + cpb], s0)
                for j in range(max(min(k, ops.NSAMPLE), 1))]
        rows += [(-1, -1)] * (-len(rows) % tile_rows)
        blocks.append([rows[t:t + tile_rows] for t in range(0, len(rows), tile_rows)])
    return blocks


def _counts(seed, s):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 129, s)
    counts[rng.integers(0, s, 3)] = (0, 128, 200)
    return counts


@pytest.mark.parametrize("tile", [16, 64, 128])
@pytest.mark.parametrize("cpb", ops.SA_CENTROIDS_PER_BLOCK)
@pytest.mark.parametrize("seed", range(4))
def test_packed_tiles_hold_every_row_once(seed, cpb, tile):
    """Each block's tiles hold tile rows; centroid s of the block owns
    max(min(count, 128), 1) consecutive rows, its kept neighbours in order
    (slot -1, the zero raw row, only for a count of 0); only the last tile
    holds rows past the block's, (-1, -1), and fewer than a tile of them."""
    s = 37 + seed * 23
    counts = _counts(seed, s)
    blocks = packed_tiles(counts, cpb, tile)
    assert len(blocks) == -(-s // cpb)
    for i, tiles in enumerate(blocks):
        rows = [r for t in tiles for r in t]
        assert all(len(t) == tile for t in tiles)
        live = [r for r in rows if r != (-1, -1)]
        assert rows[:len(live)] == live and len(rows) - len(live) < tile
        mine = range(i * cpb, min((i + 1) * cpb, s))
        want = [(c, j if counts[c] else -1) for c in mine
                for j in range(max(min(counts[c], ops.NSAMPLE), 1))]
        assert live == want


def _pool_model(x, owner, bias):
    """The wgmma kernel's max-pool of one 64-row tile, lane by lane: x
    [64, 128] f32 layer-3 accumulators, owner [64] each row's centroid (-1
    past the item's rows), bias [128]. Per warp (16 rows): where all 16
    rows are one centroid's, one butterfly without a mask; else one per
    centroid g_first .. g_last, the rows of others -inf; the bias and ReLU
    after the max; atomicMax into pmax. -> {centroid: [128] maxima}."""
    pmax = {}
    for w in range(4):
        own = owner[16 * w:16 * w + 16]
        xs = x[16 * w:16 * w + 16]
        g_all = own[0] if own[0] == own[15] else -1
        cents = [g_all] if g_all >= 0 else range(max(own[0], 0), max(own) + 1)
        for g in cents:
            for half in range(2):
                m = []
                for lane in range(32):
                    lo, q = lane >> 2, lane & 3
                    vals = []
                    for i in range(16):
                        col = 8 * (8 * half + (i >> 1)) + 2 * q + (i & 1)
                        a = xs[lo, col] if g_all >= 0 or own[lo] == g else -np.inf
                        b = xs[lo + 8, col] if g_all >= 0 or own[lo + 8] == g else -np.inf
                        vals.append(max(a, b))
                    m.append(np.array(vals, np.float32))
                for k_half in (8, 4, 2):  # lanes 16, 8 and 4 apart
                    new = []
                    for lane in range(32):
                        other = lane ^ (2 * k_half)
                        mine, theirs = m[lane], m[other]
                        # the pair both keep the half of this lane's bit
                        up = lane & (2 * k_half)
                        keep = slice(k_half, 2 * k_half) if up else slice(k_half)
                        new.append(np.maximum(mine[keep], theirs[keep]))
                    m = new
                for lane in range(32):
                    c = 8 * (8 * half + (lane >> 2)) + 2 * (lane & 3)
                    for t in range(2):
                        v = max(np.float32(m[lane][t] + bias[c + t]), np.float32(0))
                        row = pmax.setdefault(g, np.zeros(128, np.float32))
                        row[c + t] = max(row[c + t], v)
    return pmax


@pytest.mark.parametrize("seed", range(3))
def test_wgmma_pool_model_takes_each_centroids_max_over_its_rows(seed):
    """At random counts in 0..128, packed in items of 8 centroids and tiles
    of 64 rows, the model of the kernel's pool gives each centroid the max
    over exactly its rows of relu(x + bias), bit for bit: rows of other
    centroids and rows past the item's (here far above every real value)
    never enter it."""
    rng = np.random.default_rng(100 + seed)
    counts = _counts(seed, 40)
    bias = rng.normal(size=128).astype(np.float32)
    for tiles in packed_tiles(counts, 8, 64):
        got, want = {}, {}
        for tile in tiles:
            owner = np.array([c for c, _ in tile])
            x = rng.normal(size=(64, 128)).astype(np.float32)
            x[owner < 0] = 1e6
            for g, row in _pool_model(x, owner, bias).items():
                got[g] = np.maximum(got.get(g, row), row)
            for r, g in enumerate(owner):
                if g >= 0:
                    v = np.maximum(x[r] + bias, np.float32(0))
                    want[g] = np.maximum(want.get(g, v), v)
        assert sorted(got) == sorted(want)
        for g in want:
            np.testing.assert_array_equal(got[g], want[g])
