"""``train_scale``: train one pyramid scale (port of
``hpvaegan_tpu/train/trainer.py:65-468``; reference train_video.py:25-258).

Its parts: the VAE/GAN switch (``trainer.py:70``); the ``Z_init_size``
quirk at 3D, the scale-0 shape at 2D (``:73-81``); a fresh critic per
GAN scale, warm-started from the previous GAN scale's (``:100-118``);
fresh optimizers per scale; the
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

With a ``summary`` (the CLI's ``utils/summaries.TensorboardSummary``)
and ``--visualize``, every iteration writes the JAX package's scalars
(``noise_amp``, then ``KLD`` and ``Rec VAE`` or ``rec loss``, ``errG``,
``errD_fake`` and ``errD_real``, ``trainer.py:382-421``), and every
``--print-interval``-th iteration, the first included, the five sample
grids of ``_visualize`` (``:423-425, 471-503``): three rand samples and a
reconstruction from the current weights.  Those draw from a generator of
their own, ``(seed, scale, iteration, 7)``, under ``inference_mode``
without touching the BatchNorm statistics, so a run with
``--visualize`` ends with the same weights as one without.  They run
after the step's callback and report themselves to it as the event
``"visualize"``, so a step's launch counts hold only the step.

``--profile-dir`` traces ten iterations from the first at or past
iteration 5 with ``torch.profiler`` (CPU, and CUDA on the card), as the
JAX trainer traces its window (``:216-231``), and writes a Chrome trace
to ``<profile dir>/scale_<s>/trace.json``.

Under a mesh (``G.mesh``, attached by the CLI under ``--spmd
--mesh-shape``; ``trainer.py:129-140``) every rank runs ``train_scale``
in lockstep: the critic joins the generator's mesh, every stage's shape
is checked against K4's gate (``pconv_spmd_ok``) before the first step,
the loader's whole batches go to the steps, which cut each rank's block;
the critic warm start is read by rank 0 and broadcast (``:43-54``); only
rank 0 writes files (``utils/saver.py``) and traces; ``--visualize``
runs its forwards on every rank and gathers the samples whole
(``multihost.fetch``, ``:491-494``) before rank 0 writes the grids; every
scale ends by checking that the ranks still hold the same weights, and
at a barrier (``:464-465``).

Waiting for their ROADMAP items: ``--scan-steps`` and the other
fast-path options (Queue 1 item 9); the memory ladder (item 8).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.loader import make_loader
from ..models.registry import make_discriminator
from ..ops.kernels.conv3d_spmd import pconv_spmd_ok
from ..parallel import multihost
from ..parallel.mesh import attach, check_replicated
from ..utils.profiling import StepTimer
from ..utils.saver import load_critic
from ..utils.tools import create_progressbar, seeded_generator
from ..utils.watchdog import Watchdog
from .optim import build_d_optimizer, build_g_optimizer
from .steps import calibrate, gan_step, vae_step

__all__ = ["train_scale"]


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


def _check_mesh_shapes(cfg, G, mesh) -> None:
    """Raise before the first step when a stage of this scale cannot be
    split over the mesh (K4's gate, ``conv3d_spmd.pconv_spmd_ok``)."""
    shape = G.pyramid.shape3d if G.ndim == 3 else G.pyramid.shape2d
    for s in range(cfg.scale_idx + 1):
        whole = (cfg.batch_size, *shape(s), 64)
        if len(whole) == 5 and not pconv_spmd_ok(whole, (3, 3, 3, 64, 64),
                                                  mesh):
            raise ValueError(f"stage {s} of shape {whole} does not split "
                             f"over the {mesh.shape} mesh (the batch over "
                             f"data, at least one H row a spatial rank)")


def train_scale(cfg, G, batches: Optional[Iterator] = None, *, dataset=None,
                saver=None, summary=None, D_prev=None,
                seed: Optional[int] = None,
                callback: Optional[Callable[[str, int, dict], None]] = None):
    """Train scale ``cfg.scale_idx`` of ``G`` (grown to that scale, on its
    device) for ``cfg.niter`` iterations.

    Pass ``dataset`` and ``saver`` (the CLI), or ``batches``, an iterator
    of ``(real, real_zero)`` NTHWC pairs, and optionally ``D_prev``, the
    previous scale's critic.  ``seed`` defaults to ``cfg.manualSeed``.
    ``callback(event, iteration, info)`` is called after the calibration
    (``"calibrate"``, -1, ``{"rmse", "noise_amp"}``) and after every step
    (``"step"``, i, metrics), and after each ``--visualize`` sampling
    (``"visualize"``, i, ``{"seconds", "write_seconds"}``: its wall time,
    and that of encoding and writing the grids alone).
    ``summary`` receives the scalars and grids under ``--visualize``.
    Appends this scale's amp to
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
    mesh = G.mesh
    if mesh is not None:
        _check_mesh_shapes(cfg, G, mesh)
    # the reference clips over every generator parameter, frozen or not
    G.requires_grad_(True)

    h0, w0 = G.pyramid.shape2d(0)
    if G.ndim == 2:   # every scale (train_image.py:137-139)
        cfg.Z_init_size = [cfg.batch_size, h0, w0, cfg.latent_dim]
    elif dataset is not None and not getattr(cfg, "Z_init_size", None):
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
        attach(D, mesh)
        if mid is not None:
            D.load_state_dict(mid["dvars"])
        elif dataset is not None and cfg.netG and \
                cfg.resumed_idx == scale_idx:
            # the scale a --netG resume lands on warm-starts from the run
            # resumed from, as the JAX trainer does (trainer.py:111-113),
            # on the first GAN scale too: no VAE scale writes a critic, so
            # there the file is missing and load_critic raises
            _warm_start(D, os.path.join(cfg.resume_dir,
                                        f"netD_{scale_idx - 1}"))
        elif cfg.vae_levels < scale_idx:
            # warm start from the previous GAN scale (train_video.py:50-52)
            if dataset is not None:
                _warm_start(D, os.path.join(saver.experiment_dir,
                                            f"netD_{scale_idx - 1}"))
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
    profiler = None
    # under a mesh rank 0 alone traces: the ranks would share the path
    profile_done = not cfg.profile_dir or not multihost.is_primary()
    # every rank of a mesh samples (the forwards are collectives); the
    # ranks without a summary write nothing
    visualize = cfg.visualize and (summary is not None or mesh is not None)
    try:
        for it in range(start_it, cfg.niter):
            if not profile_done and profiler is None and it >= 5:
                profiler, profile_start = _start_profiler(dev), it
            elif profiler is not None and it >= profile_start + 10:
                _stop_profiler(profiler, cfg.profile_dir, scale_idx)
                profiler, profile_done = None, True
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
            if summary is not None and cfg.visualize:
                _write_scalars(summary, scale_idx, it,
                               cfg.Noise_Amps[scale_idx], metrics, gan_phase)
            if callback is not None:
                callback("step", it, metrics)
            if visualize and it % cfg.print_interval == 0:
                t0 = time.perf_counter()
                write_s = _visualize(cfg, G, amps, real, real_zero,
                                     _z_init_shape(cfg, G),
                                     seeded_generator(seed, scale_idx, it, 7,
                                                      device=dev),
                                     summary, it)
                if callback is not None:
                    callback("visualize", it,
                             {"seconds": time.perf_counter() - t0,
                              "write_seconds": write_s})
    except BaseException:
        # the checkpoints below never run on this path: disarm the
        # watchdog so it cannot end a process that handles the error
        watchdog.stop()
        raise
    finally:
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir, scale_idx)
        if dataset is not None:
            batches.close()
        bar.close()

    try:
        if mesh is not None:
            # the summed gradients keep the ranks equal: a scale that ends
            # otherwise is a fault, not a state to save
            check_replicated(G)
            if D is not None:
                check_replicated(D)
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
        # no rank starts the next scale (nor reads this scale's critic)
        # before rank 0 has written this one's files
        multihost.barrier(f"end of scale {scale_idx}")
    finally:
        watchdog.stop()
    return G, D, history


def _warm_start(D, path: str) -> None:
    """The critic from ``path``: rank 0 reads the file, the other ranks
    take its values by broadcast (no shared file system needed)."""
    if multihost.is_primary():
        load_critic(path, D)
    multihost.broadcast_pytree(D.state_dict())


def _start_profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, scale_idx: int) -> None:
    profiler.stop()
    out = os.path.join(profile_dir, f"scale_{scale_idx}")
    os.makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out, "trace.json"))


def _write_scalars(summary, scale_idx: int, it: int, noise_amp: float,
                   metrics: dict, gan_phase: bool) -> None:
    """The JAX trainer's scalars of one iteration (``trainer.py:382-421``;
    the reference's ``Video/Scale {s}`` tags, in the 2D trainer too)."""
    tag = f"Video/Scale {scale_idx}"
    summary.add_scalar(f"{tag}/noise_amp", noise_amp, it)
    names = ((("rec loss", "rec_loss"), ("errG", "errG"),
              ("errD_fake", "errD_fake"), ("errD_real", "errD_real"))
             if gan_phase else (("KLD", "kl_loss"),
                                ("Rec VAE", "rec_vae_loss")))
    for name, key in names:
        summary.add_scalar(f"{tag}/{name}", float(metrics[key]), it)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _visualize(cfg, G, amps, real, real_zero, noise_shape, generator,
               summary, iteration: int) -> float:
    """3 independent rand-mode samples and a reconstruction -> the five
    grids (``trainer.py:471-503``; reference train_video.py:225-241).
    BatchNorm uses each batch's own statistics and writes none.  Under a
    mesh every rank samples its blocks and the samples are gathered whole
    (``multihost.fetch``); a rank without ``summary`` writes nothing.
    Returns the seconds spent encoding and writing the grids (the samples
    are on the host by then)."""
    dev, mesh = G.device, G.mesh

    def host(t):
        return multihost.fetch(t, mesh, 2 if t.dim() == 5 else 1)

    with torch.inference_mode():
        fakes, fake_vaes = [], []
        for _ in range(3):
            noise = torch.randn(noise_shape, generator=generator,
                                device=dev)
            fake, fake_vae, _ = G.apply(amps, noise_init=noise, mode="rand",
                                        train=True, generator=generator)
            fakes.append(host(fake))
            fake_vaes.append(host(fake_vae))
        generated, generated_vae, _ = G.apply(
            amps, real_zero=real_zero, mode="rec", train=True,
            generator=generator)
        generated, generated_vae = host(generated), host(generated_vae)
    if summary is None:
        return 0.0
    grids = [(_host(real), "Real"), (generated, "Generated"),
             (generated_vae, "Generated VAE"),
             (np.concatenate(fakes), "Fake var"),
             (np.concatenate(fake_vaes), "Fake VAE var")]
    viz = (summary.visualize_video if G.ndim == 3
           else summary.visualize_image)
    t0 = time.perf_counter()
    for arr, name in grids:
        viz(cfg, iteration, arr, name)
    return time.perf_counter() - t0
