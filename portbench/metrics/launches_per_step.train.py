"""launches_per_step.train: device kernels the profiler saw in the traced
window, over the steps it holds."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.units:
        return None
    return len(run.trace.kernels) / run.units
