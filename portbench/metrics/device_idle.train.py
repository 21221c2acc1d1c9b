"""device_idle.train: the share of the traced training window in which
no kernel, copy or memset ran on the card."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
