"""The per-scale training steps of the HP-VAE-GAN (port of
``hpvaegan_tpu/train/steps.py:81-98, 201-374``).

Each step runs eagerly on the modules in place: spectral update, forward,
``backward``, clip and Adam.  The whole step is held in ``full_f32()``
(forwards, both backward passes, the GP's ``create_graph`` backward and
Adam), so no stock f32 conv falls back to cuDNN's default TF32.  Under
``cfg.bf16`` the models' convs compute in bf16 (the GP's stock critic
too, on cuDNN), the cotangents reaching K1 and K2 are bf16 as the JAX
package casts them, and the parameters, their gradients, the clip and
Adam stay f32; the metrics keep the JAX package's dtypes (the critic's
means and the KL bf16, the MSEs, the GP and the totals f32).

Semantics kept from the JAX package:

* the spectral power iteration runs once per step, at its start, for the
  generator's encoder SN convs and for the critic;
* BatchNorm running statistics move in the JAX package's order: the VAE
  step's rec forward; in the GAN step the generator step's rec forward,
  then its rand forward.  The critic step's fake forward discards its
  statistics (``steps.py:295-297``);
* the critic runs once on ``concat[real, fake]``; the WGAN-GP runs the
  same critic on stock convs only (``:316-323``);
* the generator step uses the critic after its Adam update, and the same
  stage noises as the critic step's fake (one ``k_fake``, ``:14-16``);
* the critic's parameters are frozen around the generator step, so no
  weight gradient is computed for them (the JAX package differentiates
  only the generator's parameters there).

Every draw can be handed in: ``eps`` (the rec forward's reparameterization
draw), ``noises`` (the stage noises), ``alpha`` (the GP's scalar);
whatever is not handed in is drawn from ``generator``.  Inputs are NTHWC
(NHWC) arrays or tensors, as ``GeneratorHPVAEGAN.apply`` takes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .. import full_f32
from ..losses import calc_gradient_penalty, kl_criterion, mse
from ..models.blocks import SNConv
from ..models.generators import to_model_layout
from .optim import clip_grad_norm_

__all__ = ["update_g_spectral", "update_d_spectral", "calibrate",
           "vae_step", "gan_step"]


def update_g_spectral(G) -> None:
    """One power-iteration step for every SN conv of the generator (the
    encoder's ``FeatureExtractor``)."""
    for m in G.encode.modules():
        if isinstance(m, SNConv):
            m.spectral_update()


def update_d_spectral(D) -> None:
    for m in D.sn_convs():
        m.spectral_update()


def _tensor(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def _update(params, opt, grad_clip: Optional[float]) -> None:
    if grad_clip is not None:
        clip_grad_norm_(params, grad_clip)
    opt.step()


def calibrate(G, real, real_zero, amps: Sequence[float], eps=None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Noise-amp probe (train_video.py:131-145): a rec forward in train
    mode that updates the BatchNorm statistics; returns
    ``sqrt(MSE(real, reconstruction))``."""
    with full_f32(), torch.no_grad():
        out, _, _ = G.apply(amps, real_zero=real_zero, mode="rec", train=True,
                            eps=eps, generator=generator, update_stats=True)
        return mse(out, _tensor(real, G.device)).sqrt()


def vae_step(G, opt_g, cfg, real, real_zero, amps: Sequence[float],
             eps=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """One VAE-phase step (``steps.py:211-240``)."""
    dev = G.device
    real, real_zero = _tensor(real, dev), _tensor(real_zero, dev)
    with full_f32():
        update_g_spectral(G)
        G.zero_grad(set_to_none=True)
        generated, generated_vae, (mu, logvar) = G.apply(
            amps, real_zero=real_zero, mode="rec", train=True, eps=eps,
            generator=generator, update_stats=True)
        kl = kl_criterion(mu, logvar)
        rec_vae = mse(generated, real) + mse(generated_vae, real_zero)
        total = cfg.rec_weight * rec_vae + cfg.kl_weight * kl
        total.backward()
        _update(G.parameters(), opt_g, cfg.grad_clip)
    return {"loss": total.detach(), "rec_vae_loss": rec_vae.detach(),
            "kl_loss": kl.detach()}


def gan_step(G, D, opt_g, opt_d, cfg, real, real_zero, noise_init,
             amps: Sequence[float], noises: Optional[Sequence] = None,
             eps=None, alpha=None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """One GAN-phase step: the critic step with the WGAN-GP, then the
    generator step against the updated critic (``steps.py:264-374``)."""
    dev = G.device
    real, real_zero = _tensor(real, dev), _tensor(real_zero, dev)
    noise_init = _tensor(noise_init, dev)
    if noises is None:
        noises = G.draw_stage_noises(real.shape[0], generator)
    with full_f32():
        update_g_spectral(G)
        update_d_spectral(D)

        # ---- critic step (train_video.py:168-183) ----
        with torch.no_grad():
            fake, _, _ = G.apply(amps, noise_init=noise_init, mode="rand",
                                 train=True, noises=noises)
        x_real, x_fake = to_model_layout(real), to_model_layout(fake)
        nb = x_real.shape[0]
        D.zero_grad(set_to_none=True)
        out = D(torch.cat([x_real, x_fake]))
        errD_real = -out[:nb].mean()
        errD_fake = out[nb:].mean()
        gp = calc_gradient_penalty(lambda x: D(x, use_kernels=False),
                                   x_real, x_fake, cfg.lambda_grad, alpha,
                                   generator)
        (errD_real + errD_fake + gp).backward()
        opt_d.step()

        # ---- generator step with the UPDATED, frozen critic ----
        D.requires_grad_(False)
        try:
            G.zero_grad(set_to_none=True)
            generated, _, _ = G.apply(amps, real_zero=real_zero, mode="rec",
                                      train=True, eps=eps,
                                      generator=generator,
                                      update_stats=True)
            fake_g, _, _ = G.apply(amps, noise_init=noise_init, mode="rand",
                                   train=True, noises=noises,
                                   update_stats=True)
            rec = mse(generated, real)
            errG = -D(to_model_layout(fake_g)).mean() * cfg.disc_loss_weight
            total = cfg.rec_weight * rec + errG
            total.backward()
        finally:
            D.requires_grad_(True)
        _update(G.parameters(), opt_g, cfg.grad_clip)
    return {"loss": total.detach(), "rec_loss": rec.detach(),
            "errG": errG.detach(), "errD_real": errD_real.detach(),
            "errD_fake": errD_fake.detach(), "gradient_penalty": gp.detach()}
