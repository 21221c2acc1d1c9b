"""The benchmark's inputs for a cell: the measured package's configuration,
its dataset's frames, and the weights, made on the card from ``--seed``.

The weights are the reference modules' (the model family's ``models``),
drawn by the family's ``draw`` from one ``torch.Generator`` on the card
seeded ``seed_value(seed, WEIGHTS_KEY)``.  The measured package takes
them through its checkpoint format (``load_state_dict``, or a ``netG``
file), so the reference keeps the very values it started from."""
from __future__ import annotations

import dataclasses

import torch

from reference.train import seed_value

__all__ = ["port_config", "reference_models", "frames_file", "WEIGHTS_KEY"]

WEIGHTS_KEY = 0x57E1   # the weights' generator: seed_value(seed, WEIGHTS_KEY)


def port_config(conf: dict, scale: int):
    """The measured package's ``Config`` from the configuration file's
    keys, scales adjusted, at ``scale``."""
    from hpvaegan_tpu_torch.core.config import Config
    # netG names the cut (random weights, no checkpoint), not a file
    names = {f.name for f in dataclasses.fields(Config)} - {"netG"}
    kw = {k: (tuple(v) if k == "sampling_rates" else v)
          for k, v in conf.items() if k in names}
    cfg = Config(**kw)
    cfg.adjust_scales()
    cfg.scale_idx = scale
    return cfg


def frames_file(conf: dict) -> str:
    from harness.cells import ROOT
    src = conf.get("video_path") or conf["image_path"]
    stem = src.rsplit(".", 1)[0]
    return str(ROOT / f"{stem}.frames.npz")


def reference_models(family, conf: dict, ndim: int, shapes, scale: int, dev,
                     seed: int):
    """``family``'s reference generator (``scale`` stages) and critic on
    ``dev``, their weights drawn from ``seed``."""
    with torch.device(dev):
        G, D = family.models(conf, ndim, shapes, scale)
    family.draw((G, D), torch.Generator(device=dev).manual_seed(
        seed_value(seed, WEIGHTS_KEY)))
    return G, D
