"""On the card (``-m gpu``): the control, the reference computed in TF32
(the nearest precision below the configurations' f32 with TF32 off), and
the fault of a step on half its batch, each read at a cell's own size,
fail the cell's limits; a sound run of the 2D cell passes them."""
import pytest
import torch

from harness.cells import load_cell
from harness.runner import run_cell

pytestmark = pytest.mark.gpu
SEED = 2 ** 31 + 777


def _over(gaps: dict, limits: dict) -> list:
    return [k for k, v in gaps.items() if k in limits and v > limits[k]]


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
