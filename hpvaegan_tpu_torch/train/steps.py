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

Under a mesh (the models' ``mesh``, ``parallel.mesh.attach``; the JAX
steps' ``mesh=``, ``steps.py:131-146``) every input and draw stays whole,
as the single-process step has it, and is cut to this rank's block where
it is used (``Mesh.shard``); the losses are this rank's shares of the
global means (``losses.py``), each rank backpropagates its share, and
every parameter's gradient is summed over the mesh in one all-reduce
before the clip and Adam (``_update``; the ``psum`` that ``shard_map``'s
transpose inserts, ``steps.py:68-71``).  The parameters then stay the
same on every rank without a broadcast.  The metrics returned are the
whole step's (the shares summed over the mesh).  ``--pfuse`` stays off
under ``--spmd`` (``core/config.py``), as K2 has no mesh partitioning.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .. import full_f32
from ..losses import calc_gradient_penalty, global_mean, kl_criterion, mse
from ..models.blocks import SNConv
from ..models.generators import to_model_layout
from ..parallel.mesh import shard
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


def _local(t, device, mesh) -> torch.Tensor:
    """A whole NTHWC (NHWC) input as an f32 tensor, cut to this rank's
    block under a mesh."""
    t = _tensor(t, device)
    return shard(t, mesh, 2 if t.dim() == 5 else 1)


def _update(params, opt, grad_clip: Optional[float], mesh=None) -> None:
    params = list(params)
    if mesh is not None:
        mesh.sum_grads(params)
    if grad_clip is not None:
        clip_grad_norm_(params, grad_clip)
    opt.step()


def _whole(metrics: Dict[str, torch.Tensor], mesh
           ) -> Dict[str, torch.Tensor]:
    """The metrics detached; under a mesh each is the sum of the ranks'
    shares (one all-reduce), in its own dtype."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is None:
        return metrics
    total = mesh.all_sum(torch.stack([v.float() for v in metrics.values()]))
    return {k: total[i].to(v.dtype)
            for i, (k, v) in enumerate(metrics.items())}


def calibrate(G, real, real_zero, amps: Sequence[float], eps=None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Noise-amp probe (train_video.py:131-145): a rec forward in train
    mode that updates the BatchNorm statistics; returns
    ``sqrt(MSE(real, reconstruction))``."""
    mesh = G.mesh
    with full_f32(), torch.no_grad():
        out, _, _ = G.apply(amps, real_zero=real_zero, mode="rec", train=True,
                            eps=eps, generator=generator, update_stats=True)
        err = mse(out, _local(real, G.device, mesh), mesh)
        return _whole({"mse": err}, mesh)["mse"].sqrt()


def vae_step(G, opt_g, cfg, real, real_zero, amps: Sequence[float],
             eps=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """One VAE-phase step (``steps.py:211-240``)."""
    dev, mesh = G.device, G.mesh
    with full_f32():
        update_g_spectral(G)
        G.zero_grad(set_to_none=True)
        generated, generated_vae, (mu, logvar) = G.apply(
            amps, real_zero=real_zero, mode="rec", train=True, eps=eps,
            generator=generator, update_stats=True)
        kl = kl_criterion(mu, logvar, mesh)
        rec_vae = (mse(generated, _local(real, dev, mesh), mesh)
                   + mse(generated_vae, _local(real_zero, dev, mesh), mesh))
        total = cfg.rec_weight * rec_vae + cfg.kl_weight * kl
        total.backward()
        _update(G.parameters(), opt_g, cfg.grad_clip, mesh)
    return _whole({"loss": total, "rec_vae_loss": rec_vae, "kl_loss": kl},
                  mesh)


def gan_step(G, D, opt_g, opt_d, cfg, real, real_zero, noise_init,
             amps: Sequence[float], noises: Optional[Sequence] = None,
             eps=None, alpha=None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """One GAN-phase step: the critic step with the WGAN-GP, then the
    generator step against the updated critic (``steps.py:264-374``)."""
    dev, mesh = G.device, G.mesh
    if D.mesh is not mesh:
        raise ValueError("the generator and the critic are on different "
                         "meshes")
    if noises is None:   # drawn whole, as the single-process step does
        noises = G.draw_stage_noises(len(real), generator)
    real = _local(real, dev, mesh)
    real_zero, noise_init = _tensor(real_zero, dev), _tensor(noise_init, dev)
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
        errD_real = -global_mean(out[:nb], mesh)
        errD_fake = global_mean(out[nb:], mesh)
        gp = calc_gradient_penalty(lambda x: D(x, use_kernels=False),
                                   x_real, x_fake, cfg.lambda_grad, alpha,
                                   generator, mesh)
        (errD_real + errD_fake + gp).backward()
        _update(D.parameters(), opt_d, None, mesh)

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
            rec = mse(generated, real, mesh)
            errG = -global_mean(D(to_model_layout(fake_g)),
                                mesh) * cfg.disc_loss_weight
            total = cfg.rec_weight * rec + errG
            total.backward()
        finally:
            D.requires_grad_(True)
        _update(G.parameters(), opt_g, cfg.grad_clip, mesh)
    return _whole({"loss": total, "rec_loss": rec, "errG": errG,
                   "errD_real": errD_real, "errD_fake": errD_fake,
                   "gradient_penalty": gp}, mesh)
