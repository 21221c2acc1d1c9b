"""critic_ms.train: the device milliseconds a GAN step launched inside the
package's ``step.critic`` span (the fake forward to the critic's Adam:
its forward, the WGAN-GP, the backward and the update), over the traced
window's steps.  Eager cells alone: nothing inside a replayed CUDA graph
has a span of its own."""
from harness.program_spans import per_span_ms


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return per_span_ms(run.trace.spans, "step.critic")
