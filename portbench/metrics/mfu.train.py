"""mfu.train: the GAN step's share of the card's f32 peak over the traced
window: the reference step's FLOPs (``yardstick.step_flops``: forwards,
backward passes and the penalty's double backward at the cell's shapes)
times the steps traced, over the window's seconds, against 67 TFLOP/s."""
from harness.yardstick import PEAK_F32_FLOPS


def read(run):
    if run.kind != "train" or run.trace is None or not run.flops_per_unit:
        return None
    return (100.0 * run.flops_per_unit * run.units / run.trace.window_s
            / PEAK_F32_FLOPS)
