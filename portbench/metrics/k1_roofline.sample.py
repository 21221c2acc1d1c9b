"""k1_roofline.sample: K1's forward's share of its roofline over the
traced requests."""
from harness.roofline import k1_share


def read(run):
    return k1_share(run) if run.kind == "sample" else None
