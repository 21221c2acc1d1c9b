"""mfu.train: the training step's share of the card's peak in the
configuration's compute dtype over the traced window: the reference
step's FLOPs (``yardstick.step_flops``: forwards, backward passes and the
penalty's double backward at the cell's shapes) times the steps traced,
over the window's seconds, against the peak the runner records
(``yardstick.peak_flops``: 67 TFLOP/s f32, 989 TFLOP/s bf16)."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.flops_per_unit:
        return None
    return (100.0 * run.flops_per_unit * run.units / run.trace.window_s
            / run.peak_flops)
