"""The model family of ``GeneratorHPVAEGAN``: what the harness needs of a
model to run a cell of a configuration whose ``generator`` is this one.
The harness loads this file by that name (``harness.cells.family``) and
names no family itself; a configuration of another generator brings
``families/<generator>.py`` with the same names.

The plain reference is ``reference/model.py`` (``Generator``, ``Critic``)
and ``reference/train.py`` (the GAN step, ``follow``, ``resume``); the
measured package's trainer is ``train/trainer.train_scale``.

The contract, every name below:

* ``LOSS_TERMS``: the step metrics the trainer's ``"step"`` callback
  reports and the reference's steps return, in one order;
* ``models(conf, ndim, shapes, stages)``: the reference generator and
  critic on the default device, weights unset; ``draw(modules, g)``
  fills them from the ``torch.Generator`` ``g`` the harness seeds;
* ``port_generator(cfg, pyramid, ndim, scale, G_ref, dev)``: the measured
  package's generator holding the reference's weights;
* ``amps_before(conf, scale)``: the noise amplitudes below the scale;
* ``train(cfg, G, D_ref, batches, dataset, workdir, seed, callback)``:
  the package's trainer for one scale, the harness's ``callback`` given;
* ``STEP``: ``(module, attribute)``, where that trainer looks its step up
  at each call (the benchmark's tests plant their faults there), and
  ``half_batch_call(step, *args, **kwargs)``: ``step`` on the first row
  of every batched input (the fault of a step that leaves half of its
  batch out);
* ``loss_gaps(got, want, conf)``: a step's loss gaps, each scaled;
* ``follow``, ``resume``, ``model_state``: the reference's steps from the
  scale's start and from a state, and that state's keys;
* ``request_draws(G, conf, g, dev)``, ``reference_clip(G, amps, z,
  noises)``: a sampling request's draws and the reference's clips;
* ``flop_step(G, D, conf, batch, dev)``, ``flop_request(G, conf, batch,
  dev)``: one step and one request on empty inputs, which
  ``harness.yardstick`` counts the FLOPs of."""
from __future__ import annotations

import math

import torch

from reference.model import BatchNorm, Conv, Critic, Generator, SNConv
from reference.train import LOSS_TERMS, follow, gan_step, model_state, resume

__all__ = ["LOSS_TERMS", "models", "draw", "port_generator", "amps_before",
           "train", "STEP", "half_batch_call", "loss_gaps", "follow",
           "resume", "model_state", "request_draws", "reference_clip",
           "flop_step", "flop_request"]

STEP = ("hpvaegan_tpu_torch.train.trainer", "gan_step")


def models(conf: dict, ndim: int, shapes, stages: int):
    """The reference generator (``stages`` stages) and critic."""
    return Generator(conf, ndim, shapes, stages), Critic(conf, ndim)


@torch.no_grad()
def draw(modules, g: torch.Generator) -> None:
    """Every conv weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (PyTorch's default, the source's init) in one call, every spectral-norm
    ``u`` a normalised N(0, 1) draw with ``v = n(W^T u)`` in a second;
    BatchNorm scale 1, shift 0."""
    dev = g.device
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


def amps_before(conf: dict, scale: int):
    """The noise amplitudes of levels ``0 .. scale - 1``: 1 at level 0,
    ``noise_amp`` above (the benchmark's input; the scale's own is
    calibrated)."""
    return [1.0] + [float(conf["noise_amp"])] * (scale - 1)


def train(cfg, G, D_ref, batches, dataset, workdir, seed: int,
          callback) -> None:
    """``train_scale`` in memory: the harness's batches, ``D_ref`` as the
    previous scale's critic (the dataset and the directory unused)."""
    from hpvaegan_tpu_torch.train.trainer import train_scale
    train_scale(cfg, G, batches, D_prev=D_ref, seed=seed, callback=callback)


def half_batch_call(step, G, D, opt_g, opt_d, cfg, real, real_zero,
                    noise_init, amps, noises=None, eps=None, **kwargs):
    """``gan_step`` on the first sample of the batch, its draws cut alike."""
    return step(G, D, opt_g, opt_d, cfg, real[:1], real_zero[:1],
                noise_init[:1], amps,
                noises=[None if n is None else n[:1] for n in noises],
                eps=eps[:1], **kwargs)


def loss_gaps(got, want, conf: dict):
    """A step's two loss gaps: the generator's total and the critic's
    (``errD_real + errD_fake + gradient_penalty``), each over the sum of
    its terms' magnitudes in the reference (the critic's total crosses
    zero as it learns)."""
    loss, rec, errG, real, fake, gp = want
    g_scale = abs(conf["rec_weight"] * rec) + abs(errG)
    d_scale = abs(real) + abs(fake) + abs(gp)
    return [abs(got[0] - loss) / g_scale,
            abs(sum(got[3:]) - (real + fake + gp)) / d_scale]


def request_draws(G: Generator, conf: dict, g: torch.Generator, dev):
    """A rand request's draws, channels last, in this order: the decoder
    latent (N, *level-0 size, latent) and the stage noises (N, *level
    size, 3) of the stages that take noise (None for the others)."""
    b = conf["batch_size"]
    z = torch.randn((b, *G.shapes[0], conf["latent_dim"]), generator=g,
                    device=dev)
    noises = [torch.randn((b, *G.shapes[j + 1], conf["nc_im"]), generator=g,
                          device=dev) if G.has_noise(j) else None
              for j in range(len(G.body))]
    return z, noises


def reference_clip(G: Generator, amps, z, noises) -> torch.Tensor:
    """The reference's rand-mode clips of ``request_draws``'s draws, with
    the noise amplitudes ``amps``, channels last."""
    out = G.rand(torch.tensor(amps, device=z.device), z.movedim(-1, 1),
                 [None if n is None else n.movedim(-1, 1) for n in noises])
    return out.movedim(1, -1)


def flop_step(G: Generator, D: Critic, conf: dict, batch: int, dev) -> None:
    """One GAN step of the reference (its forwards, both backward passes
    and the penalty's double backward), no optimizer, on empty inputs."""
    stages, shapes = len(G.body), G.shapes
    real = torch.empty((batch, conf["nc_im"], *shapes[stages]), device=dev)
    real_zero = torch.empty((batch, conf["nc_im"], *shapes[0]), device=dev)
    d = {"noise_init": torch.empty((batch, conf["latent_dim"], *shapes[0]),
                                   device=dev),
         "noises": [torch.empty((batch, conf["nc_im"], *shapes[i + 1]),
                                device=dev) if G.has_noise(i) else None
                    for i in range(stages)],
         "alpha": torch.empty((), device=dev),
         "eps": torch.empty((batch, conf["latent_dim"], *shapes[0]),
                            device=dev)}
    gan_step(G, D, conf, real, real_zero, d,
             torch.empty(stages + 1, device=dev))


@torch.no_grad()
def flop_request(G: Generator, conf: dict, batch: int, dev) -> None:
    """One rand-mode forward of the reference generator on empty inputs."""
    stages, shapes = len(G.body), G.shapes
    z = torch.empty((batch, conf["latent_dim"], *shapes[0]), device=dev)
    noises = [torch.empty((batch, conf["nc_im"], *shapes[i + 1]),
                          device=dev) if G.has_noise(i) else None
              for i in range(stages)]
    G.rand(torch.empty(stages + 1, device=dev), z, noises)
