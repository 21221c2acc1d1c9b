"""K3's launch plan on the CPU (``hpvaegan_tpu_torch/ops/kernels/conv3d.py``
``k3_instance``, ``k3_plan``), with each instance's tile as a 132-SM H100
reports it (``conv3d_lrelu_f32_config``; tests/test_torch_port_gpu.py
checks the report against this table on the card).

The walks are those of ``csrc/conv3d_lrelu.cu``: wide and narrow_in take
tiles i, i + grid, ... (``TileStage``, ``TileOnce``); narrow_out gives
block i the run of units [i * n // grid, (i + 1) * n // grid) with T
innermost (``RunStage``).  Every output pixel and channel must be written
by exactly one tile of one block.
"""
import numpy as np
import pytest

from hpvaegan_tpu_torch.ops.kernels import conv3d as k3

SMS = 132
# instance -> (tile rows, tile columns, output channels a tile (None: all
# of C_out), blocks an SM)
TILES = {"wide": (4, 32, 64, 2), "narrow_in": (4, 32, 64, 4),
         "narrow_out": (8, 64, None, 3)}


def _cfg(c_in, c_out):
    inst = k3.k3_instance(c_in, c_out)
    tile_h, tile_w, co_blk, per_sm = TILES[inst]
    return {"instance": inst, "tile_h": tile_h, "tile_w": tile_w,
            "co_blk": co_blk or c_out, "blocks_per_sm": per_sm}


# the main path's stage shapes (T, H, W), PERF.md section 4
STAGES = [(4, 18, 33), (4, 23, 41), (4, 28, 51), (5, 36, 65), (5, 45, 81),
          (5, 57, 102), (7, 72, 129), (7, 91, 162), (7, 114, 204),
          (13, 144, 256)]
# ragged against every instance's tile: H 1, 3, 5, 15, 17, 33; W 1, 31,
# 33, 63, 65, 97; T 1, 2, 3
RAGGED = [(1, 1, 1, 1), (2, 1, 3, 31), (1, 2, 5, 33), (3, 3, 15, 63),
          (1, 2, 17, 65), (2, 1, 33, 97)]
CHANNELS = [(3, 64), (64, 64), (64, 3), (4, 9), (5, 9), (5, 8), (1, 65),
            (64, 65), (2, 130), (17, 1)]


@pytest.mark.parametrize("c_in", [1, 3, 4, 5, 64])
@pytest.mark.parametrize("c_out", [1, 3, 8, 9, 64, 65])
def test_each_channel_count_reaches_its_instance(c_in, c_out):
    want = ("narrow_out" if c_out <= 8 else
            "narrow_in" if c_in <= 4 else "wide")
    assert k3.k3_instance(c_in, c_out) == want
    plan = k3.k3_plan((1, 2, 9, 7, c_in), c_out, SMS, _cfg(c_in, c_out))
    assert plan.instance == want


def _walk(plan, T):
    """[(block, b, t, h0, w0, cb)] of every tile every block takes."""
    out = []
    for i in range(plan.grid):
        if plan.instance == "narrow_out":
            lo, hi = i * plan.ntiles // plan.grid, (i + 1) * plan.ntiles // plan.grid
            for u in range(lo, hi):
                s, t = divmod(u, T)
                b, rest = divmod(s, plan.tiles_h * plan.tiles_w)
                th, tw = divmod(rest, plan.tiles_w)
                out.append((i, b, t, th, tw, 0))
        else:
            for tile in range(i, plan.ntiles, plan.grid):
                rest, cb = divmod(tile, plan.co_blocks)
                rest, tw = divmod(rest, plan.tiles_w)
                rest, th = divmod(rest, plan.tiles_h)
                b, t = divmod(rest, T)
                out.append((i, b, t, th, tw, cb))
    return out


@pytest.mark.parametrize("c_in,c_out", CHANNELS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("shape", [(2, *s) for s in STAGES] + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_tiles_cover_every_output_once(shape, c_in, c_out):
    B, T, H, W = shape
    cfg = _cfg(c_in, c_out)
    plan = k3.k3_plan((*shape, c_in), c_out, SMS, cfg)
    th_, tw_, cb_ = cfg["tile_h"], cfg["tile_w"], cfg["co_blk"]
    assert (plan.co_blocks - 1) * cb_ < c_out <= plan.co_blocks * cb_
    covered = np.zeros((plan.co_blocks, B, T, plan.tiles_h * th_,
                        plan.tiles_w * tw_), np.int16)
    for i, b, t, th, tw, cb in _walk(plan, T):
        covered[cb, b, t, th * th_:(th + 1) * th_, tw * tw_:(tw + 1) * tw_] += 1
        if plan.instance == "narrow_in":
            assert cb == i % plan.co_blocks  # the block's resident weights
    assert (covered[..., :H, :W] == 1).all()
    # the tiles reach past the output by less than a tile
    assert plan.tiles_h * th_ - H < th_ and plan.tiles_w * tw_ - W < tw_


@pytest.mark.parametrize("c_in,c_out", CHANNELS, ids=lambda v: str(v))
@pytest.mark.parametrize("shape", [(2, *s) for s in STAGES] + RAGGED
                         + [(4, 13, 144, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_persistent_grid_is_one_wave(shape, c_in, c_out):
    cfg = _cfg(c_in, c_out)
    plan = k3.k3_plan((*shape, c_in), c_out, SMS, cfg)
    assert 1 <= plan.grid <= min(plan.ntiles, SMS * cfg["blocks_per_sm"])
    if plan.instance == "narrow_in":
        assert plan.grid % plan.co_blocks == 0
    else:
        assert plan.grid == min(plan.ntiles, SMS * cfg["blocks_per_sm"])


def test_plan_rejects_another_instances_report():
    with pytest.raises(ValueError, match="narrow_out"):
        k3.k3_plan((1, 2, 9, 7, 64), 3, SMS, _cfg(64, 64))
    with pytest.raises(ValueError, match="positive"):
        k3.k3_instance(0, 3)
