"""mfu.sample: the requests' share of the card's f32 peak over the traced
window: the reference generator's rand-mode FLOPs a request
(``yardstick.request_flops``) times the requests, over the window's
seconds, against 67 TFLOP/s."""
from harness.yardstick import PEAK_F32_FLOPS


def read(run):
    if run.kind != "sample" or run.trace is None or not run.flops_per_unit:
        return None
    return (100.0 * run.flops_per_unit * run.units / run.trace.window_s
            / PEAK_F32_FLOPS)
