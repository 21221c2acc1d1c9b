"""k1_roofline.train: K1's (forward, input and weight gradients) share of
its roofline over the traced GAN steps."""
from harness.roofline import k1_share


def read(run):
    return k1_share(run) if run.kind == "train" else None
