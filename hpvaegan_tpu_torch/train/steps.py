"""The per-scale training steps (port of ``hpvaegan_tpu/train/steps.py``):
the HP-VAE-GAN's (``:81-98, 201-374``), for ``GeneratorHPVAEGAN`` and
``GeneratorVAE_nb``, and the baselines' (``:475-576``, ``baseline_step``).

Each step runs eagerly on the modules in place: spectral update, forward,
``backward``, clip and Adam.  The whole step is held in ``full_f32()``
(forwards, both backward passes, the GP's ``create_graph`` backward and
Adam), so no stock f32 conv falls back to cuDNN's default TF32, and in
``deterministic()``, so that two runs of the same draws end with the
same bits (cuDNN's default f32 weight gradients do not).  Under
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

``GeneratorVAE_nb`` (``steps.py:219-229``): its stats are the triple
``(mu, logvar, bern)`` and the VAE step adds ``kl_bern_criterion(bern)``
to the KL; both rand forwards of a GAN step read the same latents
``(z_norm, z_bern)`` (the JAX step's one ``k_fake``), as they read the
same stage noises.

Every draw can be handed in: ``eps`` (the rec forward's reparameterization
draw; for ``GeneratorVAE_nb`` the pair ``(eps_norm, eps_bern)``),
``noises`` (the stage noises), ``latents`` (``GeneratorVAE_nb``'s rand
latents), ``alpha`` (the GP's scalar); whatever is not handed in is drawn
from ``generator``, before the step's first forward, in the order
``gan_draws`` (and ``G.draw_eps``) draws it.  Inputs are NTHWC (NHWC)
arrays or tensors, as the generators' ``apply`` takes them.

The fast-path modes of ``gan_step`` (``steps.py:150-199, 264-374``):

* ``--fast-grads`` is the trainer's freeze (``optim.freeze_frozen``): the
  steps differentiate what still requires a gradient, and the clip sees
  the trainable gradients only;
* ``--fused-forwards``: both steps run ``G.apply_fused`` with the same
  ``eps`` and noises (the JAX step's one ``k_fake``); the generator
  step's ``generated`` is its rec half.  Only where ``noise_init``'s and
  ``real_zero``'s spatial shapes match (after a resume the quirk's
  ``Z_init_size`` may differ, ``steps.py:273-283``), and only for
  generators with split forwards (not ``GeneratorVAE_nb``).  Fusion takes
  precedence over the hoist;
* ``--hoist-prefix`` under ``--fast-grads`` (``optim.hoist_index``): the
  critic step computes the frozen prefix once without a gradient, and the
  generator step runs its rec forward, then the rand suffix on that
  prefix.  The frozen prefix's BatchNorm running statistics then see only
  the rec forward's update (the JAX package's deviation).

``--wpack`` (``models/packed.py``; JAX ``steps.py:43-70, 306-326``):
every critic forward of ``gan_step`` (the critic step's, the WGAN-GP's,
the generator step's) runs the SN critic over packed W at a qualifying
shape (``_critic``), ahead of the kernel routes, and the generator's
refinement stages pack as ``G.cfg`` says (``models/generators.py``).
``baseline_step`` never packs, as the JAX package's baselines steps.

Without ``--wpack`` the WGAN-GP runs the stock critic in every mode.
The kernel route exists (K1 and K4 are differentiable any number of
times, and
``calc_gradient_penalty(lambda x: D(x, use_kernels=True), ...)`` works
on a critic without ``pfuse``), but the trainer keeps the JAX package's
routing (``steps.py:316-323``), chosen there because on a TPU the kernel
route measured slower; switching it waits for a benchmark cell.

The memory rungs (``train/fallback.py``; ``steps.py:153-156, 305-325,
492-530``): under ``--remat``/``--remat-blocks`` the critic's forwards
(with the kernels, on stock convs in the GP, frozen in the generator
step) are recomputed in the backward (``models/remat.py``), and the
generator's stages through ``G.cfg``; under ``--gp-chunked`` the SN
critic's penalty runs one sample at a time and backpropagates itself
(``losses.calc_gradient_penalty``), so the step backpropagates the
other critic terms alone.  The BatchNorm baselines critic keeps the
batched penalty (its train-mode statistics couple the samples).

The baselines' step (``baseline_step``; reference
train_video_baselines.py:120-173) is a pure GAN step:

* ``Dsteps`` critic updates, each on a fake recomputed from the same
  ``noise_init`` and stage noises (the generator's BatchNorm statistics
  move in each), each with its own GP draw (``fold_in(k_gp, j)``);
* the critic, either the SN ``WDiscriminator`` (the default, with its
  kernel routes; its GP on stock convs, as the main step's) or the
  BatchNorm ``WDiscriminatorBaselines``, runs on the real batch, then on
  the fake, each forward moving its running statistics; its GP forward
  moves none and keeps the whole batch (PARITY.md, remat note 2);
* the generator step: ``errG`` on the rand forward against the updated,
  frozen critic, plus ``alpha * MSE`` of the rec forward from the fixed
  ``Z_init`` when ``alpha > 0``; its gradients are applied ``Gsteps``
  times, Adam advancing each time (``:172-173``); no clip;
* the metrics ``errG``, ``rec_loss``, ``errD_real``, ``errD_fake``,
  ``gradient_penalty`` (the last critic update's).

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

import numpy as np
import torch

from .. import deterministic, full_f32
from ..losses import (calc_gradient_penalty, global_mean, kl_bern_criterion,
                      kl_criterion, mse)
from ..models.blocks import SNConv
from ..models.generators import to_model_layout
from ..models.networks import WDiscriminator, WDiscriminatorBaselines
from ..models.packed import wdisc_apply_packed, wpack_ok
from ..models.remat import remat, remat_level
from ..parallel.mesh import shard
from ..utils.profiling import span
from .optim import clip_grad_norm_, hoist_index

__all__ = ["update_g_spectral", "update_d_spectral", "calibrate",
           "vae_step", "gan_draws", "gan_step", "calibrate_baselines",
           "baseline_step"]


def update_g_spectral(G) -> None:
    """One power-iteration step for every SN conv of the generator (the
    encoder's ``FeatureExtractor``; the baselines have none)."""
    for m in G.modules():
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


def _gp_chunked(cfg, D):
    """``cfg.gp_chunked`` for a critic whose samples do not interact;
    False for the BatchNorm baselines critic (``steps.py:327, 530``)."""
    if isinstance(D, WDiscriminatorBaselines):
        return False
    return getattr(cfg, "gp_chunked", False)


def _critic(D, cfg, level):
    """The critic's forward as ``gan_step`` runs it, at remat ``level``
    (JAX ``apply_disc`` with ``cfg``, ``steps.py:43-70``): the SN critic
    over packed W under ``--wpack`` at a qualifying shape
    (``models/packed.py``), whatever ``use_kernels`` asks, since the
    JAX package's WGAN-GP critic keeps ``cfg`` (``:316-326``); else
    ``D``'s own routes."""
    def forward(x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        if isinstance(D, WDiscriminator) and wpack_ok(cfg, x.shape):
            return remat(wdisc_apply_packed, D, x, level == "blocks",
                         enabled=level)
        return D(x, use_kernels=use_kernels, remat=level)
    return forward


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
    with full_f32(), deterministic(), torch.no_grad():
        out, _, _ = G.apply(amps, real_zero=real_zero, mode="rec", train=True,
                            eps=eps, generator=generator, update_stats=True)
        err = mse(out, _local(real, G.device, mesh), mesh)
        return _whole({"mse": err}, mesh)["mse"].sqrt()


def vae_step(G, opt_g, cfg, real, real_zero, amps: Sequence[float],
             eps=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """One VAE-phase step (``steps.py:211-240``)."""
    dev, mesh = G.device, G.mesh
    if eps is None:
        eps = G.draw_eps(tuple(np.shape(real_zero)), generator)
    with full_f32(), deterministic():
        update_g_spectral(G)
        G.zero_grad(set_to_none=True)
        generated, generated_vae, stats = G.apply(
            amps, real_zero=real_zero, mode="rec", train=True, eps=eps,
            generator=generator, update_stats=True)
        kl = kl_criterion(stats[0], stats[1], mesh)
        if len(stats) == 3:   # GeneratorVAE_nb's Bernoulli gate
            kl = kl + kl_bern_criterion(stats[2], mesh)
        rec_vae = (mse(generated, _local(real, dev, mesh), mesh)
                   + mse(generated_vae, _local(real_zero, dev, mesh), mesh))
        total = cfg.rec_weight * rec_vae + cfg.kl_weight * kl
        total.backward()
        _update(G.parameters(), opt_g, cfg.grad_clip, mesh)
    return _whole({"loss": total, "rec_vae_loss": rec_vae, "kl_loss": kl},
                  mesh)


def gan_draws(G, noise_init, real_zero_shape, noises=None, latents=None,
              alpha=None, eps=None,
              generator: Optional[torch.Generator] = None) -> dict:
    """Every draw of a GAN step, in the order the step consumes them: the
    stage noises and ``GeneratorVAE_nb``'s latents (made once, so that
    the critic step's fake and the generator step's share them), the
    GP's ``alpha``, the rec forward's ``eps``.  A draw handed in is kept;
    the others come from ``generator``.  The trainer draws them ahead
    this way for a step it replays (``train/graphs.py``): the numbers are
    those of the step drawing them itself."""
    if noises is None:   # drawn whole, as the single-process step does
        noises = G.draw_stage_noises(real_zero_shape[0], generator)
    if latents is None and hasattr(G, "draw_latents"):
        latents = G.draw_latents(noise_init, generator)
    if alpha is None:
        alpha = torch.rand((), generator=generator, device=G.device)
    if eps is None:
        eps = G.draw_eps(real_zero_shape, generator)
    return {"noises": noises, "latents": latents, "alpha": alpha,
            "eps": eps}


def gan_step(G, D, opt_g, opt_d, cfg, real, real_zero, noise_init,
             amps: Sequence[float], noises: Optional[Sequence] = None,
             eps=None, alpha=None,
             generator: Optional[torch.Generator] = None,
             latents=None) -> Dict[str, torch.Tensor]:
    """One GAN-phase step: the critic step with the WGAN-GP, then the
    generator step against the updated critic (``steps.py:264-374``),
    fused or hoisted as ``cfg`` asks (see the module's docstring)."""
    dev, mesh = G.device, G.mesh
    if D.mesh is not mesh:
        raise ValueError("the generator and the critic are on different "
                         "meshes")
    real = _local(real, dev, mesh)
    real_zero, noise_init = _tensor(real_zero, dev), _tensor(noise_init, dev)
    d = gan_draws(G, noise_init, tuple(real_zero.shape), noises, latents,
                  alpha, eps, generator)
    rand_kw = {"noises": d["noises"]}
    if d["latents"] is not None:
        rand_kw["noise_init_norm"], rand_kw["noise_init_bern"] = d["latents"]
    # the decoder's input geometry must match for the batch [rec | rand]:
    # Z_init_size's T (the first scale trained) may not be real_zero's
    fused = (cfg.fused_forwards and G.split_forwards
             and noise_init.shape[1:-1] == real_zero.shape[1:-1])
    hoist = None if fused else hoist_index(cfg, G, len(G.body))
    critic = _critic(D, cfg, remat_level(cfg))
    with full_f32(), deterministic():
        with span("step.spectral"):
            update_g_spectral(G)
            update_d_spectral(D)

        # ---- critic step (train_video.py:168-183) ----
        with span("step.critic"):
            with torch.no_grad():
                if fused:
                    _, fake, _, _ = G.apply_fused(amps, real_zero, noise_init,
                                                  train=True, eps=d["eps"],
                                                  noises=d["noises"])
                elif hoist is not None:
                    # the frozen prefix, once: the generator step reuses it
                    x_pre, _, _, at = G.apply_prefix(
                        amps, noise_init=noise_init, mode="rand", train=True,
                        upto=hoist, **rand_kw)
                    fake = G.apply_suffix(amps, x_pre, at, mode="rand",
                                          train=True, noises=d["noises"])
                else:
                    fake, _, _ = G.apply(amps, noise_init=noise_init,
                                         mode="rand", train=True, **rand_kw)
            x_real, x_fake = to_model_layout(real), to_model_layout(fake)
            nb = x_real.shape[0]
            D.zero_grad(set_to_none=True)
            out = critic(torch.cat([x_real, x_fake]))
            errD_real = -global_mean(out[:nb], mesh)
            errD_fake = global_mean(out[nb:], mesh)
            with span("step.critic.penalty"):
                gp = calc_gradient_penalty(
                    lambda x: critic(x, use_kernels=False), x_real, x_fake,
                    cfg.lambda_grad, d["alpha"], mesh=mesh,
                    chunked=_gp_chunked(cfg, D))
            with span("step.critic.backward"):
                (errD_real + errD_fake + gp).backward()
            with span("step.critic.update"):
                _update(D.parameters(), opt_d, None, mesh)

        # ---- generator step with the UPDATED, frozen critic ----
        with span("step.generator"):
            D.requires_grad_(False)
            try:
                G.zero_grad(set_to_none=True)
                if fused:
                    generated, fake_g, _, _ = G.apply_fused(
                        amps, real_zero, noise_init, train=True,
                        eps=d["eps"], noises=d["noises"], update_stats=True)
                else:
                    generated, _, _ = G.apply(amps, real_zero=real_zero,
                                              mode="rec", train=True,
                                              eps=d["eps"], update_stats=True)
                    if hoist is not None:
                        fake_g = G.apply_suffix(amps, x_pre, at, mode="rand",
                                                train=True,
                                                noises=d["noises"],
                                                update_stats=True)
                    else:
                        fake_g, _, _ = G.apply(amps, noise_init=noise_init,
                                               mode="rand", train=True,
                                               update_stats=True, **rand_kw)
                rec = mse(generated, real, mesh)
                errG = -global_mean(critic(to_model_layout(fake_g)),
                                    mesh) * cfg.disc_loss_weight
                total = cfg.rec_weight * rec + errG
                with span("step.generator.backward"):
                    total.backward()
            finally:
                D.requires_grad_(True)
            with span("step.generator.update"):
                _update(G.parameters(), opt_g, cfg.grad_clip, mesh)
    return _whole({"loss": total, "rec_loss": rec, "errG": errG,
                   "errD_real": errD_real, "errD_fake": errD_fake,
                   "gradient_penalty": gp}, mesh)


def calibrate_baselines(G, real, z_init, amps: Sequence[float]
                        ) -> torch.Tensor:
    """The baselines' noise-amp probe (``steps.py:503-507``): a rec forward
    from the fixed ``z_init`` in train mode that updates the BatchNorm
    statistics; returns ``sqrt(MSE(real, reconstruction))``."""
    mesh = G.mesh
    with full_f32(), deterministic(), torch.no_grad():
        out = G.apply(amps, noise_init=z_init, mode="rec", train=True,
                      update_stats=True)
        err = mse(out, _local(real, G.device, mesh), mesh)
        return _whole({"mse": err}, mesh)["mse"].sqrt()


def baseline_step(G, D, opt_g, opt_d, cfg, real, noise_init, z_init,
                  amps: Sequence[float], noises: Optional[Sequence] = None,
                  alphas: Optional[Sequence[float]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """One step of the baselines (``steps.py:509-565``): ``cfg.Dsteps``
    critic updates, then the generator update applied ``cfg.Gsteps``
    times.  ``noises``: the rand forwards' stage noises; ``alphas``: one
    GP draw a critic update."""
    dev, mesh = G.device, G.mesh
    if D.mesh is not mesh:
        raise ValueError("the generator and the critic are on different "
                         "meshes")
    real = _local(real, dev, mesh)
    noise_init, z_init = _tensor(noise_init, dev), _tensor(z_init, dev)
    if noises is None:
        noises = G.draw_stage_noises(len(noise_init), generator)
    x_real = to_model_layout(real)
    zero = torch.zeros((), device=dev)
    errD_real = errD_fake = gp = zero
    level = remat_level(cfg)
    with full_f32(), deterministic():
        update_d_spectral(D)
        # ---- Dsteps critic updates (train_video_baselines.py:126-150) ----
        for j in range(cfg.Dsteps):
            with torch.no_grad():
                fake = G.apply(amps, noise_init=noise_init, mode="rand",
                               train=True, noises=noises, update_stats=True)
            x_fake = to_model_layout(fake)
            D.zero_grad(set_to_none=True)
            errD_real = -global_mean(D(x_real, update_stats=True,
                                       remat=level), mesh)
            errD_fake = global_mean(D(x_fake, update_stats=True,
                                      remat=level), mesh)
            gp = calc_gradient_penalty(
                lambda x: D(x, use_kernels=False, remat=level), x_real,
                x_fake, cfg.lambda_grad,
                None if alphas is None else alphas[j], generator, mesh,
                chunked=_gp_chunked(cfg, D))
            (errD_real + errD_fake + gp).backward()
            _update(D.parameters(), opt_d, None, mesh)

        # ---- generator step (train_video_baselines.py:155-173) ----
        D.requires_grad_(False)
        try:
            G.zero_grad(set_to_none=True)
            fake_g = G.apply(amps, noise_init=noise_init, mode="rand",
                             train=True, noises=noises, update_stats=True)
            errG = -global_mean(D(to_model_layout(fake_g), remat=level),
                                mesh) * cfg.disc_loss_weight
            total, rec = errG, zero
            if cfg.alpha > 0:
                generated = G.apply(amps, noise_init=z_init, mode="rec",
                                    train=True, update_stats=True)
                rec = cfg.alpha * mse(generated, real, mesh)
                total = total + rec
            total.backward()
        finally:
            D.requires_grad_(True)
        params = list(G.parameters())
        if mesh is not None:
            mesh.sum_grads(params)
        # Gsteps optimizer steps on the SAME gradients, as the reference
        for _ in range(cfg.Gsteps):
            opt_g.step()
    return _whole({"errG": errG, "rec_loss": rec, "errD_real": errD_real,
                   "errD_fake": errD_fake, "gradient_penalty": gp}, mesh)
