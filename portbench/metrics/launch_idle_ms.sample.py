"""launch_idle_ms.sample: for each traced request, the interval from the
first start to the last end of the device operations its
``serve.forward`` launched, less the union of their durations: the
device waiting on the host's launches inside the forward; the median, in
ms."""
from harness.program_spans import launch_idle_ms


def read(run):
    if run.kind != "sample" or run.trace is None:
        return None
    return launch_idle_ms(run.trace.spans)
