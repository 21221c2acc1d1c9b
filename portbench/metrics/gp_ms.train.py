"""gp_ms.train: one WGAN-GP penalty and its backward on the trainer's
critic route at the cell's critic and shapes, in ms (CUDA events, the
median of three after one untimed), timed after the traced window."""


def read(run):
    return run.gp_ms if run.kind == "train" else None
