"""host_tail_ms.sample: for each traced request, the end of its
``serve.host`` span (the cast, gather and copy of its clips to the host)
less the end of the last device operation its ``serve.forward`` launched:
what the host adds after the device is done; the median, in ms."""
from harness.program_spans import host_tail_ms


def read(run):
    if run.kind != "sample" or run.trace is None:
        return None
    return host_tail_ms(run.trace.spans)
