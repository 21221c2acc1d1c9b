"""The launch plan of K1's weight-gradient kernels (``dw_plan``), on the
CPU: chunks, grid and scratch from the kernels' own report (blocks an SM,
grid blocks a chunk, row-tile width) and the shape.

Both instances' reports as a 132-SM H100 gives them
(``conv3d64_dw_{f32,bf16}_config``): f32 3 blocks an SM, 9 (dt, dh) pair
blocks a chunk, 64-pixel row tiles; bf16 1 block an SM, 3 dt blocks a
chunk, 128-pixel row tiles.  The f32 kernel walks every row tile of its
chunk for every pair; the bf16 kernel walks, for temporal tap dt, the rows
of the time steps whose x slice t + dt - 1 lies inside the clip.
"""
import pytest

from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

SMS = 132
INSTANCES = {"f32": dict(blocks_per_sm=3, blocks_per_chunk=9, tile_w=64),
             "bf16": dict(blocks_per_sm=1, blocks_per_chunk=3, tile_w=128)}
# the main path's stage shapes (T, H, W), PERF.md section 4
STAGES = [(4, 18, 33), (4, 23, 41), (4, 28, 51), (5, 36, 65), (5, 45, 81),
          (5, 57, 102), (7, 72, 129), (7, 91, 162), (7, 114, 204),
          (13, 144, 256)]
MAIN = [(b, *s) for s in STAGES for b in (2, 4)]
RAGGED = [(1, 1, 1, 1), (3, 2, 7, 63), (1, 13, 7, 65), (1, 2, 144, 129),
          (3, 1, 1, 256), (1, 13, 144, 1), (1, 1, 1, 300)]
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535


def _chunk_rows(rows, chunk, nchunk):
    """The rows of ``chunk`` as both kernels split them
    (``csrc/conv3d_dw.cu``: ``begin = rows * chunk / nchunk``)."""
    return range(rows * chunk // nchunk, rows * (chunk + 1) // nchunk)


def _rows_per_group(kind, shape, tile_w):
    """Rows each grid x-index walks, as the kernel enumerates them."""
    B, T, H, W = shape
    tiles_w = -(-W // tile_w)
    if kind == "f32":
        return [B * T * H * tiles_w] * 9
    return [B * (T - (dt != 1)) * H * tiles_w for dt in range(3)]


@pytest.mark.parametrize("kind", sorted(INSTANCES))
@pytest.mark.parametrize("shape", MAIN + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_dw_plan_covers_every_row_once(kind, shape):
    cfg = INSTANCES[kind]
    plan = cp.dw_plan(SMS, cfg["blocks_per_sm"], cfg["blocks_per_chunk"],
                      cfg["tile_w"], shape)
    B, T, H, W = shape
    tiles = B * T * H * -(-W // cfg["tile_w"])
    assert 1 <= plan.nchunk <= tiles
    # one wave: no more blocks than the card holds at once
    assert plan.grid == (cfg["blocks_per_chunk"], plan.nchunk)
    assert plan.grid[0] * plan.grid[1] <= SMS * cfg["blocks_per_sm"] \
        or plan.nchunk == 1
    assert plan.grid[0] <= GRID_X_MAX and plan.grid[1] <= GRID_Y_MAX
    assert plan.scratch_floats == plan.nchunk * 27 * 64 * 64
    for rows in _rows_per_group(kind, shape, cfg["tile_w"]):
        seen = [0] * rows
        for c in range(plan.nchunk):
            for r in _chunk_rows(rows, c, plan.nchunk):
                seen[r] += 1
        assert all(n == 1 for n in seen)


@pytest.mark.parametrize("sms,blocks_per_sm,blocks_per_chunk,want", [
    (132, 3, 9, 44), (132, 1, 3, 44), (114, 3, 9, 38), (1, 1, 3, 1),
    (16, 2, 3, 10)])
def test_dw_plan_follows_the_reported_occupancy(sms, blocks_per_sm,
                                                blocks_per_chunk, want):
    """The chunks follow the SMs and blocks an SM the kernel reports (no
    constant copied from its launch bounds), on the critic's shape, which
    has rows enough for any card; a card too small for one chunk's wave
    still gets one."""
    plan = cp.dw_plan(sms, blocks_per_sm, blocks_per_chunk, 128,
                      (4, 13, 144, 256))
    assert plan.nchunk == want


def test_dw_plan_caps_chunks_at_the_row_tiles():
    assert cp.dw_plan(132, 3, 9, 64, (1, 1, 2, 64)).nchunk == 2
    assert cp.dw_plan(132, 1, 3, 128, (1, 1, 1, 129)).nchunk == 2
