"""``train_scale``: train one pyramid scale (port of
``hpvaegan_tpu/train/trainer.py:65-468``; reference train_video.py:25-258).

Its parts: the VAE/GAN switch (``trainer.py:70``); the ``Z_init_size``
quirk (``:73-81``); a fresh critic per GAN scale, warm-started from the
previous GAN scale's (``:100-118``); fresh optimizers per scale; the
noise-amp calibration at the scale's first iteration (``noise_amp =
noise_amp_init * rmse / batch_size``, ``:239-261``), or the reuse of an
amp already calibrated when a resume lands in the scale (``:241-247``);
then ``cfg.niter`` steps, each beating the watchdog and advancing the
progress bar with the step timer's suffix.

Two forms:

* on files, as the training CLI runs it (``dataset`` and ``saver``): the
  batches come from ``data/loader.py`` seeded ``seed * 1000 + scale``;
  the critic warm start is read from the ``netD_<s-1>`` file; a
  ``netG_mid`` resume (``apply_resume``) restores the critic, both
  optimizer states and the iteration (``:83-96, 109-127``);
  ``--save-interval`` writes ``netG_mid`` (``:366-377``); the scale ends
  with the ``Noise_Amps``, ``Noise_Amps.json``, ``netG`` and ``netD_<s>``
  files (``:441-465``);
* in memory (``batches``, ``D_prev``), as tests and ``chip_smoke.py``
  drive it: the batches and the previous critic are handed in, nothing is
  written, and every step's metrics are kept.

Every draw of iteration ``i`` (the decoder latent, the stage noises, the
reparameterization and GP draws) comes from a generator seeded by
``(seed, scale, i)``, and the calibration's from ``(seed, scale)``, as the
JAX package keys them by ``fold_in(key, iteration)`` (``:232-233``): a run
resumed from ``netG_mid`` replays exactly the draws of the run it resumes
and ends with the same weights.  (The numbers differ from JAX's threefry
draws; the tests inject JAX's draws into the steps instead.)

Waiting for their ROADMAP items: TensorBoard scalars and sample grids
(Queue 1 item 4); ``--scan-steps`` and the other fast-path options
(item 9); the memory ladder (item 8); SPMD (item 12).
"""
from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.loader import make_loader
from ..models.registry import make_discriminator
from ..utils.profiling import StepTimer
from ..utils.saver import load_critic
from ..utils.tools import create_progressbar
from ..utils.watchdog import Watchdog
from .optim import build_d_optimizer, build_g_optimizer
from .steps import calibrate, gan_step, vae_step

__all__ = ["train_scale", "seeded_generator"]


def seeded_generator(seed: int, *key: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` whose state depends only on
    ``(seed, *key)`` (numpy's ``SeedSequence`` mixes them)."""
    state = np.random.SeedSequence(entropy=int(seed),
                                   spawn_key=tuple(int(k) for k in key))
    value = int(state.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def _z_init_shape(cfg, G) -> Tuple[int, ...]:
    """The decoder latent of the GAN step's rand forwards:
    ``cfg.Z_init_size`` where it is set (the JAX package's quirk: the
    temporal depth of the first scale trained), else the scale-0 shape
    of the pyramid."""
    size = getattr(cfg, "Z_init_size", None)
    if size:
        return tuple(size)
    shape = (G.pyramid.shape3d(0) if G.ndim == 3 else G.pyramid.shape2d(0))
    return (cfg.batch_size, *shape, cfg.latent_dim)


def _calibrate_amp(cfg, G, real, real_zero, scale_idx: int,
                   generator: torch.Generator) -> Optional[torch.Tensor]:
    """This scale's amp into ``cfg.Noise_Amps`` (``trainer.py:239-261``);
    returns the calibration's rmse, or None when none ran."""
    if len(cfg.Noise_Amps) >= scale_idx + 1:
        # a resume inside an already calibrated scale reuses its amp
        # (the JAX package's fix of the reference's re-append)
        return None
    if cfg.const_amp or scale_idx == 0:
        cfg.Noise_Amps.append(1.0)
        return None
    cfg.Noise_Amps.append(0.0)
    rmse = calibrate(G, real, real_zero, cfg.Noise_Amps, generator=generator)
    cfg.Noise_Amps[-1] = cfg.noise_amp_init * float(rmse) / cfg.batch_size
    return rmse


def train_scale(cfg, G, batches: Optional[Iterator] = None, *, dataset=None,
                saver=None, D_prev=None, seed: Optional[int] = None,
                callback: Optional[Callable[[str, int, dict], None]] = None):
    """Train scale ``cfg.scale_idx`` of ``G`` (grown to that scale, on its
    device) for ``cfg.niter`` iterations.

    Pass ``dataset`` and ``saver`` (the CLI), or ``batches``, an iterator
    of ``(real, real_zero)`` NTHWC pairs, and optionally ``D_prev``, the
    previous scale's critic.  ``seed`` defaults to ``cfg.manualSeed``.
    ``callback(event, iteration, info)`` is called after the calibration
    (``"calibrate"``, -1, ``{"rmse", "noise_amp"}``) and after every step
    (``"step"``, i, metrics).  Appends this scale's amp to
    ``cfg.Noise_Amps`` unless it is there already.

    Returns ``(G, D or None, [metrics per step])``; the list stays empty
    in the file form."""
    if (batches is None) == (dataset is None):
        raise ValueError("pass either batches or a dataset")
    if dataset is not None and saver is None:
        raise ValueError("training from a dataset needs a saver")
    scale_idx = cfg.scale_idx
    dev = G.device
    gan_phase = cfg.vae_levels < scale_idx + 1
    seed = int(cfg.manualSeed or 0) if seed is None else int(seed)
    # the reference clips over every generator parameter, frozen or not
    G.requires_grad_(True)

    if dataset is not None and G.ndim == 3 and \
            not getattr(cfg, "Z_init_size", None):
        h0, w0 = G.pyramid.shape2d(0)
        # the reference's quirk: the td of the FIRST scale trained
        cfg.Z_init_size = [cfg.batch_size, cfg.td, h0, w0, cfg.latent_dim]

    mid, start_it = None, 0
    if cfg.resumed_idx == scale_idx and \
            getattr(cfg, "_mid_raw", None) is not None:
        mid, cfg._mid_raw = cfg._mid_raw, None  # later scales start fresh
        start_it = min(int(cfg.resume_iteration), cfg.niter)

    D = opt_d = None
    if gan_phase:
        D = make_discriminator(cfg.discriminator, cfg, G.ndim)
        D.reset_parameters(torch.Generator().manual_seed(
            seed * 1000 + 101 + scale_idx))
        D.to(dev)
        if mid is not None:
            D.load_state_dict(mid["dvars"])
        elif dataset is not None and cfg.netG and \
                cfg.resumed_idx == scale_idx:
            # the scale a --netG resume lands on warm-starts from the run
            # resumed from, as the JAX trainer does (trainer.py:111-113),
            # on the first GAN scale too: no VAE scale writes a critic, so
            # there the file is missing and load_critic raises
            load_critic(os.path.join(cfg.resume_dir,
                                     f"netD_{scale_idx - 1}"), D)
        elif cfg.vae_levels < scale_idx:
            # warm start from the previous GAN scale (train_video.py:50-52)
            if dataset is not None:
                load_critic(os.path.join(saver.experiment_dir,
                                         f"netD_{scale_idx - 1}"), D)
            elif D_prev is not None:
                D.load_state_dict(D_prev.state_dict())
        opt_d = build_d_optimizer(cfg, D)
        if mid is not None:
            opt_d.load_state_dict(mid["opt_d"])
    opt_g = build_g_optimizer(cfg, G, scale_idx)
    if mid is not None:
        opt_g.load_state_dict(mid["opt_g"])

    if dataset is not None:
        batches = make_loader(dataset, cfg, seed, scale_idx, dev,
                              start_iteration=start_it)
    bar = create_progressbar(
        total=cfg.niter, initial=start_it,
        desc=f"Training scale [{scale_idx + 1}/{cfg.stop_scale + 1}]")
    timer = StepTimer(sync_every=50, device=dev)
    watchdog = Watchdog(cfg.watchdog,
                        context=f"scale {scale_idx} start").start()
    save_interval = int(cfg.save_interval)
    history, amps = [], None
    try:
        for it in range(start_it, cfg.niter):
            real, real_zero = next(batches)
            if amps is None:
                rmse = _calibrate_amp(cfg, G, real, real_zero, scale_idx,
                                      seeded_generator(seed, scale_idx,
                                                       device=dev))
                if rmse is not None and callback is not None:
                    callback("calibrate", -1, {"rmse": rmse,
                                               "noise_amp":
                                                   cfg.Noise_Amps[-1]})
                amps = list(cfg.Noise_Amps)
            draw = seeded_generator(seed, scale_idx, it, device=dev)
            if gan_phase:
                noise_init = torch.randn(_z_init_shape(cfg, G),
                                         generator=draw, device=dev)
                metrics = gan_step(G, D, opt_g, opt_d, cfg, real, real_zero,
                                   noise_init, amps, generator=draw)
            else:
                metrics = vae_step(G, opt_g, cfg, real, real_zero, amps,
                                   generator=draw)
            bar.update(1)
            timer.step()
            watchdog.beat(f"scale {scale_idx} iteration {it + 1}")
            if saver is not None and save_interval > 0 and \
                    it + 1 < cfg.niter and (it + 1) % save_interval == 0:
                watchdog.beat(f"scale {scale_idx} mid checkpoint "
                              f"(iteration {it + 1})")
                saver.save_checkpoint(
                    {"scale": scale_idx, "iteration": it + 1,
                     "gvars": G.state_dict(), "opt_g": opt_g.state_dict(),
                     "dvars": D.state_dict() if gan_phase else {},
                     "opt_d": opt_d.state_dict() if gan_phase else {},
                     "noise_amps": list(cfg.Noise_Amps)}, "netG_mid")
            bar.set_description(
                f"Scale [{scale_idx + 1}/{cfg.stop_scale + 1}], "
                f"Iteration [{it + 1}/{cfg.niter}]" + timer.suffix)
            if dataset is None:
                history.append(metrics)
            if callback is not None:
                callback("step", it, metrics)
    except BaseException:
        # the checkpoints below never run on this path: disarm the
        # watchdog so it cannot end a process that handles the error
        watchdog.stop()
        raise
    finally:
        if dataset is not None:
            batches.close()
        bar.close()

    try:
        if saver is not None:
            watchdog.beat(f"scale {scale_idx} checkpoint save")
            amps_now = list(cfg.Noise_Amps)
            saver.save_checkpoint({"data": torch.tensor(amps_now)},
                                  "Noise_Amps")
            saver.save_json({"noise_amps": amps_now, "scale": scale_idx},
                            "Noise_Amps.json")
            saver.save_checkpoint({"scale": scale_idx,
                                   "gvars": G.state_dict(),
                                   "noise_amps": amps_now,
                                   "opt_g": opt_g.state_dict()}, "netG")
            if gan_phase:
                saver.save_checkpoint({"scale": scale_idx,
                                       "dvars": D.state_dict(),
                                       "opt_d": opt_d.state_dict()},
                                      f"netD_{scale_idx}", blocking=True)
            saver.wait()
    finally:
        watchdog.stop()
    return G, D, history
