"""generator_ms.train: the device milliseconds a GAN step launched inside
the package's ``step.generator`` span (zero_grad to the generator's Adam:
the rec and rand forwards, the critic's score, the backward, the clip and
the update), over the traced window's steps.  Eager cells alone: nothing
inside a replayed CUDA graph has a span of its own."""
from harness.program_spans import per_span_ms


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return per_span_ms(run.trace.spans, "step.generator")
