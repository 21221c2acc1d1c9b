"""The benchmark's inputs for a cell: the measured package's configuration,
its dataset, and the weights, made on the card from ``--seed``.

The weights are the reference modules' (``reference/model.py``), drawn
in two calls of a ``torch.Generator`` on the card: every conv weight and
bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default, the source's
init), every spectral-norm ``u`` a normalised N(0, 1) draw with ``v =
n(W^T u)``; BatchNorm scale 1, shift 0.  The measured package takes
them through its checkpoint format (``load_state_dict``, or a ``netG``
file), so the reference keeps the very values it started from."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from reference.model import BatchNorm, Conv, Critic, Generator, SNConv
from reference.train import seed_value

__all__ = ["port_config", "amps_before", "reference_models",
           "port_generator", "frames_file"]

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


def amps_before(conf: dict, scale: int):
    """The noise amplitudes of levels ``0 .. scale - 1``: 1 at level 0,
    ``noise_amp`` above (the benchmark's input; the scale's own is
    calibrated)."""
    return [1.0] + [float(conf["noise_amp"])] * (scale - 1)


@torch.no_grad()
def _draw(modules, dev, seed: int) -> None:
    g = torch.Generator(device=dev).manual_seed(seed_value(seed, WEIGHTS_KEY))
    convs = [m for mod in modules for m in mod.modules()
             if isinstance(m, (Conv, SNConv))]
    leaves = [(p, 1.0 / math.sqrt(m.weight[0].numel()))
              for m in convs for p in (m.weight, m.bias)]
    flat = torch.rand(sum(p.numel() for p, _ in leaves), generator=g,
                      device=dev)
    at = 0
    for p, b in leaves:
        n = p.numel()
        p.copy_((flat[at:at + n] * 2 - 1).view_as(p) * b)
        at += n
    sns = [m for m in convs if isinstance(m, SNConv)]
    us = torch.randn(sum(m.u.numel() for m in sns), generator=g, device=dev)
    at = 0
    for m in sns:
        n = m.u.numel()
        u = us[at:at + n]
        m.u.copy_(u / (torch.linalg.vector_norm(u) + 1e-12))
        v = m.weight.reshape(n, -1).T @ m.u
        m.v.copy_(v / (torch.linalg.vector_norm(v) + 1e-12))
        at += n
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def reference_models(conf: dict, ndim: int, shapes, scale: int, dev,
                     seed: int) -> Tuple[Generator, Critic]:
    """The reference generator (``scale`` stages) and critic on ``dev``,
    their weights drawn from ``seed``."""
    with torch.device(dev):
        G, D = Generator(conf, ndim, shapes, scale), Critic(conf, ndim)
    _draw((G, D), dev, seed)
    return G, D


def port_generator(cfg, pyramid, ndim: int, scale: int, G_ref, dev):
    """The measured package's generator grown to ``scale`` stages on
    ``dev``, holding ``G_ref``'s weights."""
    from hpvaegan_tpu_torch.models.registry import make_generator
    with torch.device(dev):
        G = make_generator(cfg.generator, cfg, pyramid, ndim)
        for _ in range(scale):
            G.init_next_stage()
    G.load_state_dict(G_ref.state_dict())
    return G
