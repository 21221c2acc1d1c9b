"""On the card (``-m gpu``): the control, the reference computed in TF32
(the nearest precision below the configurations' f32 with TF32 off), and
the fault of a step on half its batch, each read at a cell's own size,
fail the cell's limits; a sound run of the 2D cell passes them; the
penalty that ``gp_ms.train`` times takes the trainer's route, K1 on a 3D
K1 critic."""
import pytest
import torch

from harness.cells import load_cell
from harness.runner import run_cell

pytestmark = pytest.mark.gpu
SEED = 2 ** 31 + 777


def _over(gaps: dict, limits: dict) -> list:
    return [k for k, v in gaps.items()
            if limits.get(k) is not None and v > limits[k]]


def test_training_control_and_half_batch_fail(card):
    from tools.readings import train_controls
    cell = load_cell("hpvaegan2d.train_s9_replay")
    got = train_controls(cell, SEED, card)
    assert _over(got["control"], cell.limits), got
    assert _over(got["half_batch"], cell.limits), got


def test_sampling_control_fails(card):
    from tools.readings import sample_controls
    cell = load_cell("hpvaegan3d.sample_s9")
    got = sample_controls(cell, SEED, card)
    assert _over(got["control"], cell.limits), got


def test_sound_run_passes(card):
    cell = load_cell("hpvaegan2d.train_s9_replay")
    result, _ = run_cell(cell, SEED, 1, False, card)   # a window of a chunk
    assert result["correct"], result["checks"]
    torch.cuda.empty_cache()


def test_gp_ms_times_the_penalty_on_k1(card):
    from harness.models import port_config, reference_models
    from harness.trace import Tracer
    from harness.train_cell import _gp_ms
    cell = load_cell("hpvaegan3d.train_s9")
    shapes = [(4, 18, 33)]          # level 0 of the 3D pyramid
    _, D_ref = reference_models(cell.family, cell.config, 3, shapes, 0,
                                card, SEED)
    real = torch.rand((2, 3, *shapes[0]), device=card) * 2 - 1
    tracer = Tracer(card)
    tracer.start()
    ms = _gp_ms(port_config(cell.config, 0), 3, D_ref, real, card, SEED)
    window = tracer.stop()
    assert ms > 0
    # four penalties and backwards: 5 K1 forwards, 10 dx and 5 dw each
    assert window.kernel_count("conv3d64_") >= 4 * 20, window.device_ops
