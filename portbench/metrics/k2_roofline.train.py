"""k2_roofline.train: K2's (the fused critic pair) share of its roofline
over the traced GAN steps."""
from harness.roofline import k2_share


def read(run):
    return k2_share(run) if run.kind == "train" else None
