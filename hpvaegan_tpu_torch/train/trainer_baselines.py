"""``train_scale_baselines``: train one pyramid scale of the SinGAN /
ConSinGAN video baselines (port of
``hpvaegan_tpu/train/trainer_baselines.py``; reference
train_video_baselines.py:24-213).

Unlike the HP-VAE-GAN's ``train_scale`` there is no VAE phase: a critic
exists at every scale and every step is ``steps.baseline_step``.  Its
parts, in the JAX trainer's order:

* the fixed reconstruction noise ``Z_init`` (batch, T0, H0, W0, nc_im),
  drawn once per run from ``(seed, 999)`` at the first scale trained and
  checkpointed at once (``:33-40``); a ``--netG`` resume reloads it
  instead (``cli/train_video_baselines.py``);
* the critic, built fresh and warm-started from ``netD_<s-1>`` of this
  run, or of the run resumed from when this run has none (the JAX
  package's fix of a reference resume bug, PARITY.md deviation 3;
  ``:58-79``); from ``netG_mid`` on a mid-scale resume;
* fresh optimizers (``baselines_group_plan``, no gradient clip);
* the amp at the scale's first iteration: reused when the run already
  has it, 1 at scale 0, else ``noise_amp_init * rmse / batch_size`` from
  a rec forward on ``Z_init`` (``:161-176``);
* ``cfg.niter`` steps, each on a batch from the port's loader and a fresh
  ``noise_init`` of ``Z_init``'s shape, every draw of iteration ``i``
  from ``seeded_generator(seed, scale, i)`` as in ``train_scale``, so a
  ``netG_mid`` resume replays the draws of the run it resumes;
  ``--save-interval`` writes ``netG_mid``;
* under ``--visualize``, the baselines' scalars every step (``errG``,
  ``errD_fake``, ``errD_real``, and with ``alpha > 0`` ``rec_loss`` and
  ``noise_amp``; ``:209-221``) and every ``--print-interval``-th step the
  ``Real``, ``Fake`` (rand from the step's noise) and, with
  ``alpha > 0``, ``Generated`` (rec from ``Z_init``) grids (``:222-236``),
  sampled from their own generator without touching the BatchNorm
  statistics, so the weights end as without ``--visualize``;
* at the scale's end the files ``Z_init``, ``Noise_Amps``,
  ``Noise_Amps.json``, ``netG`` and ``netD_<s>`` (``:244-259``).

Under a mesh (``--spmd --mesh-shape Dx1``; ``:94-105``) the generator and
the critic are attached to it by the CLI, the batch is split over
``data`` and the gradients summed, as in ``train_scale``; a spatial axis
raises (the baselines' VALID convs are not partitioned along H).  Only
rank 0 writes.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.loader import make_loader
from ..models.registry import make_discriminator
from ..parallel import multihost
from ..parallel.mesh import attach, check_replicated
from ..utils.profiling import StepTimer
from ..utils.tools import create_progressbar, seeded_generator
from ..utils.watchdog import Watchdog
from .optim import build_d_optimizer, build_g_optimizer
from .steps import baseline_step, calibrate_baselines
from .trainer import _host, _start_profiler, _stop_profiler, _warm_start

__all__ = ["train_scale_baselines", "z_init_shape"]


def z_init_shape(cfg, G):
    """``Z_init``'s shape: the batch at scale 0's H and W, image channels
    and the T of the scale being trained (``trainer_baselines.py:36-40``:
    scale 0's in a run from scratch; a resume reloads ``Z_init``)."""
    h0, w0 = G.pyramid.shape2d(0)
    return (cfg.batch_size, cfg.td, h0, w0, cfg.nc_im)


def train_scale_baselines(cfg, G, dataset, saver, summary=None,
                          seed: Optional[int] = None,
                          callback: Optional[Callable[[str, int, dict],
                                                      None]] = None):
    """Train scale ``cfg.scale_idx`` of the baseline ``G`` (grown to that
    scale, on its device) for ``cfg.niter`` iterations on ``dataset``,
    writing through ``saver``.  ``cfg.Z_init`` is drawn and saved when
    absent.  ``callback(event, iteration, info)`` as ``train_scale``'s.
    Appends this scale's amp to ``cfg.Noise_Amps`` unless it is there
    already.  Returns ``(G, D)``."""
    scale_idx = cfg.scale_idx
    dev, mesh = G.device, G.mesh
    seed = int(cfg.manualSeed or 0) if seed is None else int(seed)
    if mesh is not None and mesh.n_spatial > 1:
        raise NotImplementedError(
            f"{cfg.generator} over a spatial mesh axis: its VALID convs are "
            f"not partitioned along H (use a Dx1 mesh)")
    G.requires_grad_(True)

    if getattr(cfg, "Z_init", None) is None:
        cfg.Z_init = torch.randn(z_init_shape(cfg, G),
                                 generator=seeded_generator(seed, 999,
                                                            device=dev),
                                 device=dev)
        saver.save_checkpoint({"data": cfg.Z_init}, "Z_init")
    z_init = cfg.Z_init.to(dev)

    mid, start_it = None, 0
    if cfg.resumed_idx == scale_idx and \
            getattr(cfg, "_mid_raw", None) is not None:
        mid, cfg._mid_raw = cfg._mid_raw, None  # later scales start fresh
        start_it = min(int(cfg.resume_iteration), cfg.niter)

    # a critic at every scale (train_video_baselines.py:45-48)
    D = make_discriminator(cfg.discriminator, cfg, G.ndim)
    D.reset_parameters(torch.Generator().manual_seed(
        seed * 1000 + 101 + scale_idx))
    D.to(dev)
    attach(D, mesh)
    if mid is not None:
        D.load_state_dict(mid["dvars"])
    elif scale_idx > 0:
        name = f"netD_{scale_idx - 1}"
        directory = saver.experiment_dir
        if not os.path.exists(os.path.join(directory, name)) and \
                cfg.resume_dir:
            directory = cfg.resume_dir
        _warm_start(D, os.path.join(directory, name))
    opt_d = build_d_optimizer(cfg, D)
    opt_g = build_g_optimizer(cfg, G, scale_idx)
    if mid is not None:
        opt_d.load_state_dict(mid["opt_d"])
        opt_g.load_state_dict(mid["opt_g"])

    batches = make_loader(dataset, cfg, seed, scale_idx, dev,
                          start_iteration=start_it)
    bar = create_progressbar(
        total=cfg.niter, initial=start_it,
        desc=f"Training scale [{scale_idx + 1}/{cfg.stop_scale + 1}]")
    timer = StepTimer(sync_every=50, device=dev)
    watchdog = Watchdog(cfg.watchdog,
                        context=f"scale {scale_idx} start").start()
    save_interval = int(cfg.save_interval)
    profiler, amps = None, None
    profile_done = not cfg.profile_dir or not multihost.is_primary()
    visualize = cfg.visualize and (summary is not None or mesh is not None)
    try:
        for it in range(start_it, cfg.niter):
            if not profile_done and profiler is None and it >= 5:
                profiler, profile_start = _start_profiler(dev), it
            elif profiler is not None and it >= profile_start + 10:
                _stop_profiler(profiler, cfg.profile_dir, scale_idx)
                profiler, profile_done = None, True
            real, _ = next(batches)
            if amps is None:
                _calibrate_amp(cfg, G, real, z_init, scale_idx, callback)
                amps = list(cfg.Noise_Amps)
            draw = seeded_generator(seed, scale_idx, it, device=dev)
            noise_init = torch.randn(z_init.shape, generator=draw,
                                     device=dev)
            metrics = baseline_step(G, D, opt_g, opt_d, cfg, real,
                                    noise_init, z_init, amps,
                                    generator=draw)
            bar.update(1)
            timer.step()
            watchdog.beat(f"scale {scale_idx} iteration {it + 1}")
            if save_interval > 0 and it + 1 < cfg.niter and \
                    (it + 1) % save_interval == 0:
                watchdog.beat(f"scale {scale_idx} mid checkpoint "
                              f"(iteration {it + 1})")
                saver.save_checkpoint(
                    {"scale": scale_idx, "iteration": it + 1,
                     "gvars": G.state_dict(), "opt_g": opt_g.state_dict(),
                     "dvars": D.state_dict(), "opt_d": opt_d.state_dict(),
                     "noise_amps": list(cfg.Noise_Amps)}, "netG_mid")
            bar.set_description(
                f"Scale [{scale_idx + 1}/{cfg.stop_scale + 1}], "
                f"Iteration [{it + 1}/{cfg.niter}]" + timer.suffix)
            if summary is not None and cfg.visualize:
                _write_scalars(summary, cfg, scale_idx, it,
                               cfg.Noise_Amps[scale_idx], metrics)
            if callback is not None:
                callback("step", it, metrics)
            if visualize and it % cfg.print_interval == 0:
                t0 = time.perf_counter()
                write_s = _visualize(cfg, G, amps, real, noise_init, z_init,
                                     seeded_generator(seed, scale_idx, it, 7,
                                                      device=dev),
                                     summary, it)
                if callback is not None:
                    callback("visualize", it,
                             {"seconds": time.perf_counter() - t0,
                              "write_seconds": write_s})
    except BaseException:
        watchdog.stop()   # the checkpoints below never run on this path
        raise
    finally:
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir, scale_idx)
        batches.close()
        bar.close()

    try:
        if mesh is not None:
            check_replicated(G)
            check_replicated(D)
        watchdog.beat(f"scale {scale_idx} checkpoint save")
        amps_now = list(cfg.Noise_Amps)
        saver.save_checkpoint({"data": z_init}, "Z_init")
        saver.save_checkpoint({"data": torch.tensor(amps_now)},
                              "Noise_Amps")
        saver.save_json({"noise_amps": amps_now, "scale": scale_idx},
                        "Noise_Amps.json")
        saver.save_checkpoint({"scale": scale_idx, "gvars": G.state_dict(),
                               "noise_amps": amps_now,
                               "opt_g": opt_g.state_dict()}, "netG")
        saver.save_checkpoint({"scale": scale_idx, "dvars": D.state_dict(),
                               "opt_d": opt_d.state_dict()},
                              f"netD_{scale_idx}", blocking=True)
        saver.wait()
        multihost.barrier(f"end of scale {scale_idx}")
    finally:
        watchdog.stop()
    return G, D


def _calibrate_amp(cfg, G, real, z_init, scale_idx: int, callback) -> None:
    """This scale's amp into ``cfg.Noise_Amps`` (``trainer_baselines.py:
    161-176``): reused on a resume, 1 at scale 0, else calibrated."""
    if len(cfg.Noise_Amps) >= scale_idx + 1:
        return
    if scale_idx == 0:
        cfg.Noise_Amps.append(1.0)
        return
    cfg.Noise_Amps.append(0.0)
    rmse = calibrate_baselines(G, real, z_init, cfg.Noise_Amps)
    cfg.Noise_Amps[-1] = cfg.noise_amp_init * float(rmse) / cfg.batch_size
    if callback is not None:
        callback("calibrate", -1, {"rmse": rmse,
                                   "noise_amp": cfg.Noise_Amps[-1]})


def _write_scalars(summary, cfg, scale_idx: int, it: int, noise_amp: float,
                   metrics: dict) -> None:
    """The JAX baselines trainer's scalars of one iteration
    (``trainer_baselines.py:209-221``)."""
    tag = f"Video/Scale {scale_idx}"
    for name in ("errG", "errD_fake", "errD_real"):
        summary.add_scalar(f"{tag}/{name}", float(metrics[name]), it)
    if cfg.alpha > 0:
        summary.add_scalar(f"{tag}/rec_loss", float(metrics["rec_loss"]), it)
        summary.add_scalar(f"{tag}/noise_amp", noise_amp, it)


def _visualize(cfg, G, amps, real, noise_init, z_init, generator, summary,
               iteration: int) -> float:
    """The ``Real``, ``Fake`` and (``alpha > 0``) ``Generated`` grids
    (``trainer_baselines.py:222-236``): a rand forward from the step's
    noise (fresh stage noises) and a rec forward from ``Z_init``, in
    train mode without updating the BatchNorm statistics; gathered whole
    under a mesh.  Returns the seconds spent encoding and writing."""
    mesh = G.mesh

    def host(t):
        return multihost.fetch(t, mesh, 2)

    with torch.inference_mode():
        grids = [(_host(real), "Real"),
                 (host(G.apply(amps, noise_init=noise_init, mode="rand",
                               train=True, generator=generator)), "Fake")]
        if cfg.alpha > 0:
            grids.append((host(G.apply(amps, noise_init=z_init, mode="rec",
                                       train=True)), "Generated"))
    if summary is None:
        return 0.0
    t0 = time.perf_counter()
    for arr, name in grids:
        summary.visualize_video(cfg, iteration, np.asarray(arr), name)
    return time.perf_counter() - t0
