"""gp_ms.train: one WGAN-GP penalty and its backward on the trainer's
critic route (``steps._penalty_critic``: a 3D K1 critic's body on K1,
unfused; a critic without K1 on stock convs) at the cell's critic and
shapes, in ms (CUDA events, the median of three after one untimed), timed
after the traced window."""


def read(run):
    return run.gp_ms if run.kind == "train" else None
