"""The launch plans of the persistent bf16 kernels, on the CPU: K1's
forward (``fwd_plan``, 8 x 64 output tiles of one frame) and K2's pair
(``pair_plan``, columns of 6 x 28 output tiles through all of T), with
the tiles as a 132-SM H100 reports them (``conv3d64_fwd_bf16_config``,
``conv3d64_pair_bf16_config``: one block an SM).

Block i of the grid walks tiles i, i + grid, ... (``csrc/conv3d_pack.cu``
``FwdTile``, ``csrc/conv3d_fuse.cu`` ``PairColumn``): every tile, and so
every output pixel, must be walked by exactly one block.
"""
import pytest

from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

SMS = 132
K1_TILE, K2_TILE = (8, 64), (6, 28)
# the main path's stage shapes (T, H, W), PERF.md section 4
STAGES = [(4, 18, 33), (4, 23, 41), (4, 28, 51), (5, 36, 65), (5, 45, 81),
          (5, 57, 102), (7, 72, 129), (7, 91, 162), (7, 114, 204),
          (13, 144, 256)]
MAIN = [(b, *s) for s in STAGES for b in (2, 4)]
# every edge of both tilings: W 1, 28, 29, 63, 64, 65, 129, 256; H 1, 6,
# 7, 8, 9, 144; T 1, 2, 13; B 1, 3
EDGES = [(1, 1, 1, 1), (3, 2, 7, 63), (1, 13, 7, 65), (1, 2, 144, 129),
         (3, 1, 1, 256), (1, 13, 144, 1), (1, 2, 8, 64), (2, 3, 9, 28),
         (1, 2, 6, 29), (3, 1, 13, 57)]


def _walk(plan):
    """The tiles each block of the grid takes, as the kernels walk them."""
    return [list(range(i, plan.ntiles, plan.grid)) for i in range(plan.grid)]


def _k1_tile(tile, T, tiles_h, tiles_w):
    """``FwdTile``: (b, t, h0, w0) of a tile index."""
    w0 = (tile % tiles_w) * K1_TILE[1]
    r = tile // tiles_w
    h0 = (r % tiles_h) * K1_TILE[0]
    r //= tiles_h
    return r // T, r % T, h0, w0


def _k2_column(col, tiles_h, tiles_w):
    """``PairColumn``: (b, h0, w0) of a column index."""
    w0 = (col % tiles_w) * K2_TILE[1]
    r = col // tiles_w
    return r // tiles_h, (r % tiles_h) * K2_TILE[0], w0


@pytest.mark.parametrize("shape", MAIN + EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fwd_plan_walks_every_pixel_once(shape):
    B, T, H, W = shape
    plan = cp.fwd_plan(SMS, 1, *K1_TILE, shape)
    assert 1 <= plan.grid <= min(SMS, plan.ntiles)
    covered = {}
    for tiles in _walk(plan):
        for tile in tiles:
            b, t, h0, w0 = _k1_tile(tile, T, plan.tiles_h, plan.tiles_w)
            assert 0 <= b < B and 0 <= t < T and h0 < H and w0 < W
            for h in range(h0, min(h0 + K1_TILE[0], H)):
                key = (b, t, h, w0)
                covered[key] = covered.get(key, 0) + 1
    # each (b, t, row) is walked once by each of its column tiles, and the
    # column tiles cover W
    assert len(covered) == B * T * H * plan.tiles_w
    assert set(covered.values()) == {1}
    assert (plan.tiles_w - 1) * K1_TILE[1] < W <= plan.tiles_w * K1_TILE[1]
    assert (plan.tiles_h - 1) * K1_TILE[0] < H <= plan.tiles_h * K1_TILE[0]


@pytest.mark.parametrize("shape", MAIN + EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_pair_plan_walks_every_column_once(shape):
    B, T, H, W = shape
    plan = cf.pair_plan(SMS, 1, *K2_TILE, shape)
    assert plan.ntiles == B * plan.tiles_h * plan.tiles_w
    assert 1 <= plan.grid <= min(SMS, plan.ntiles)
    seen = [0] * plan.ntiles
    pixels = set()
    for cols in _walk(plan):
        for col in cols:
            seen[col] += 1
            b, h0, w0 = _k2_column(col, plan.tiles_h, plan.tiles_w)
            assert 0 <= b < B and h0 < H and w0 < W
            pixels.update((b, h, w)
                          for h in range(h0, min(h0 + K2_TILE[0], H))
                          for w in range(w0, min(w0 + K2_TILE[1], W)))
    assert set(seen) == {1}
    assert len(pixels) == B * H * W


@pytest.mark.parametrize("sms,per_sm,want", [(132, 1, 132), (114, 1, 114),
                                             (132, 2, 264), (1, 1, 1)])
def test_plans_follow_the_reported_occupancy(sms, per_sm, want):
    """One wave of the blocks the card holds, from the kernel's own
    report, on the critic's shape (tiles enough for any card)."""
    shape = (4, 13, 144, 256)
    assert cp.fwd_plan(sms, per_sm, *K1_TILE, shape).grid == want
    assert cf.pair_plan(sms, per_sm, *K2_TILE, shape).grid == want


def test_plans_never_launch_more_blocks_than_tiles():
    assert cp.fwd_plan(SMS, 1, *K1_TILE, (1, 1, 1, 1)).grid == 1
    assert cp.fwd_plan(SMS, 1, *K1_TILE, (1, 2, 9, 65)).grid == 8
    assert cf.pair_plan(SMS, 1, *K2_TILE, (1, 13, 7, 29)).grid == 4
