"""The frozen yardstick: each bound against hand-worked counts at the K1
and K2 shapes of PERF.md section 6, and the FLOP count of a step and of
a request against the sum of their convolutions worked out by hand."""
import pytest

from harness.yardstick import (PEAK_F32_FLOPS, PEAK_HBM_BYTES, dw_bound,
                               k1_bound, pair_bound, request_flops,
                               step_flops)

TOP = (2, 13, 144, 256)       # a top-stage activation, batch 2
CRITIC = (4, 13, 144, 256)    # the critic on [real, fake]


def test_k1_at_the_top_stage():
    v = 2 * 13 * 144 * 256                      # 958,464 voxels
    flops = 2 * 27 * 64 * 64 * v                # 211,996,901,376
    assert flops == 211_996_901_376
    t, by = k1_bound(TOP)
    assert by == "operations"
    assert t == pytest.approx(flops / 67e12)
    assert t * 1e3 == pytest.approx(3.1641, abs=5e-5)   # PERF.md: 3.1641


def test_dw_and_pair_at_the_critic():
    t, by = dw_bound(CRITIC)
    assert by == "operations" and t * 1e3 == pytest.approx(6.3283, abs=5e-5)
    t, by = pair_bound(CRITIC)
    assert by == "operations" and t * 1e3 == pytest.approx(12.6565,
                                                          abs=5e-5)


def test_bytes_bound_a_one_voxel_launch():
    t, by = k1_bound((1, 1, 1, 1))
    nbytes = 4 * (2 * 64 + 27 * 64 * 64 + 64)   # x, y; w; b
    assert by == "bytes" and t == pytest.approx(nbytes / PEAK_HBM_BYTES)
    t, by = pair_bound((1, 1, 1, 1), with_mid=True)
    nbytes = 4 * (3 * 64 + 2 * (27 * 64 * 64 + 64))
    assert by == "bytes" and t == pytest.approx(nbytes / PEAK_HBM_BYTES)
    assert PEAK_F32_FLOPS == 67e12


CFG = dict(generator="GeneratorHPVAEGAN", nc_im=3, nfc=4, latent_dim=2,
           vae_levels=1, enc_blocks=1, ker_size=3, padd_size=1, num_layer=1,
           train_all=False, lambda_grad=0.1, rec_weight=10.0,
           disc_loss_weight=1.0)
SHAPES = [(5, 6), (7, 8)]     # 2D levels 0 and 1


def _conv(cin, cout, hw, batch):
    return 2 * 9 * cin * cout * hw[0] * hw[1] * batch


def _stack(cin, cout, hw, batch):
    """head, one block, tail at one level."""
    return (_conv(cin, 4, hw, batch) + _conv(4, 4, hw, batch)
            + _conv(4, cout, hw, batch))


def test_request_flops_by_hand():
    b = 2
    want = _stack(2, 3, SHAPES[0], b) + _stack(3, 3, SHAPES[1], b)
    assert request_flops(CFG, 2, SHAPES, 1, b) == want


def test_step_flops_counts_every_pass():
    b = 2
    # the generator's forward (decoder and stage) and the critic's
    gen = _stack(2, 3, SHAPES[0], b) + _stack(3, 3, SHAPES[1], b)
    enc = _conv(3, 4, SHAPES[0], b) + _conv(4, 4, SHAPES[0], b) + 2 * _conv(
        4, 2, SHAPES[0], b)
    critic = _stack(3, 1, SHAPES[1], 1)          # a forward a sample
    got = step_flops(CFG, 2, SHAPES, 1, b)
    # at least: the critic-step fake and the two generator forwards, the
    # encoder once, the critic on 2b, on b in the penalty and on b in the
    # generator step, and more for every backward
    floor = 3 * gen + enc + critic * (2 * b + b + b)
    assert floor < got < 6 * floor
