"""``train_scale``: train one pyramid scale (port of the core of
``hpvaegan_tpu/train/trainer.py:65-468``; reference train_video.py:25-258).

Its parts: the VAE/GAN switch (``trainer.py:70``); a fresh critic, or a
warm start from the previous scale's critic handed in memory; fresh
optimizers for the scale; the iteration-0 noise-amp calibration
(``noise_amp = noise_amp_init * rmse / batch_size``, ``:251-261``); then
``cfg.niter`` steps over an iterator of ``(real, real_zero)`` batches.

Waiting for their ROADMAP items: the data loader (Queue 1 item 2); the
netG/netD checkpoint files, resume, TensorBoard and the watchdog (item 3);
``--scan-steps`` and the other fast-path options (item 9).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from ..models.registry import make_discriminator
from .optim import build_d_optimizer, build_g_optimizer
from .steps import calibrate, gan_step, vae_step

__all__ = ["train_scale"]


def _z_init_shape(cfg, G) -> Tuple[int, ...]:
    """The decoder latent of the GAN step's rand forwards:
    ``cfg.Z_init_size`` where a trainer set it (the JAX package's quirk:
    the temporal depth of the first scale trained), else the scale-0 shape
    of the pyramid."""
    size = getattr(cfg, "Z_init_size", None)
    if size:
        return tuple(size)
    shape = (G.pyramid.shape3d(0) if G.ndim == 3 else G.pyramid.shape2d(0))
    return (cfg.batch_size, *shape, cfg.latent_dim)


def train_scale(cfg, G, batches: Iterator, *, D_prev=None, seed: int = 0,
                callback: Optional[Callable[[str, int, dict], None]] = None):
    """Train scale ``cfg.scale_idx`` of ``G`` (grown to that scale, on its
    device) for ``cfg.niter`` iterations.

    ``batches`` yields ``(real, real_zero)`` NTHWC pairs.  ``D_prev`` is the
    previous scale's critic, warm-starting this one when that scale was a
    GAN scale too (train_video.py:44-55).  Draws come from generators
    seeded with ``seed`` and the scale.  ``callback(event, iteration,
    info)`` is called after the calibration (``"calibrate"``, -1,
    ``{"rmse", "noise_amp"}``) and after every step (``"step"``, i,
    metrics).  Appends this scale's amp to ``cfg.Noise_Amps``.

    Returns ``(G, D or None, [metrics per step])``."""
    scale_idx = cfg.scale_idx
    dev = G.device
    gan_phase = cfg.vae_levels < scale_idx + 1
    draw = torch.Generator(device=dev).manual_seed(seed * 1000 + scale_idx)
    # the reference clips over every generator parameter, frozen or not
    G.requires_grad_(True)

    D = opt_d = None
    if gan_phase:
        D = make_discriminator(cfg.discriminator, cfg, G.ndim)
        if D_prev is not None and cfg.vae_levels < scale_idx:
            D.load_state_dict(D_prev.state_dict())
        else:
            D.reset_parameters(torch.Generator().manual_seed(
                seed * 1000 + 101 + scale_idx))
        D.to(dev)
        opt_d = build_d_optimizer(cfg, D)
    opt_g = build_g_optimizer(cfg, G, scale_idx)

    real, real_zero = next(batches)
    if cfg.const_amp or scale_idx == 0:
        cfg.Noise_Amps.append(1.0)
    else:
        cfg.Noise_Amps.append(0.0)
        rmse = calibrate(G, real, real_zero, cfg.Noise_Amps, generator=draw)
        cfg.Noise_Amps[-1] = cfg.noise_amp_init * float(rmse) / cfg.batch_size
        if callback is not None:
            callback("calibrate", -1, {"rmse": rmse,
                                       "noise_amp": cfg.Noise_Amps[-1]})
    amps = list(cfg.Noise_Amps)

    history = []
    for it in range(cfg.niter):
        if it > 0:
            real, real_zero = next(batches)
        if gan_phase:
            noise_init = torch.randn(_z_init_shape(cfg, G), generator=draw,
                                     device=dev)
            metrics = gan_step(G, D, opt_g, opt_d, cfg, real, real_zero,
                               noise_init, amps, generator=draw)
        else:
            metrics = vae_step(G, opt_g, cfg, real, real_zero, amps,
                               generator=draw)
        history.append(metrics)
        if callback is not None:
            callback("step", it, metrics)
    return G, D, history
