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
  ``netG_mid`` resume (``apply_resume``; the port's or the JAX
  package's) restores the critic, both optimizer states and the
  iteration (``:83-96, 109-127``);
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
to ``<profile dir>/scale_<s>/trace.json``, the package's spans
(``utils/profiling.span``) among its kernels: ``train.chunk`` (a chunk's
inputs and steps, K = 1 a chunk of one), ``train.inputs`` (an
iteration's draws), ``train.callback`` (every call of ``callback``), and
those of the graph, the steps and the generator below them.

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

The fast path (ROADMAP Queue 1 item 9, ``trainer.py:149-167, 211,
239-403``):

* ``--fast-grads`` freezes the plan's frozen groups for the scale
  (``optim.freeze_frozen``) and thaws the generator at its end;
  ``--hoist-prefix`` and ``--fused-forwards`` are modes of the steps;
* the batches come from the device-resident cache
  (``data/device_cache.py``) unless ``--host-loader``: the steps take
  its rows and gather on the device;
* ``--scan-steps K`` runs chunks of ``k = min(K, niter - it)``
  iterations, cut at ``--print-interval`` boundaries under
  ``--visualize``.  On the cache a chunk of k > 1 draws its k rows at
  once, so when one starts the scale its rows begin after the
  calibration's (the JAX trainer's ``next`` then ``draw(k)``, PARITY.md
  deviation 10); on ``--host-loader`` the calibration batch is the
  chunk's first, so any K consumes K = 1's batches.  Every iteration
  keeps its own draws and its scalars at its true index; ``netG_mid`` is
  written when a chunk crosses a ``--save-interval`` multiple, and a
  resume from it continues the chunked run; the timer counts k steps and
  the trace window starts at a chunk boundary.  With K > 1 the callback
  sees ``("chunk", first iteration, {"k", "replays",
  "graph_pool_bytes"})`` before the chunk's ``"step"`` events.  On the
  card the scale's steps run through one ``train/graphs.StepGraph``:
  the first eagerly, the rest replayed from a CUDA graph, bit-equal to
  eager steps; on the CPU, and under a mesh (whose gloo collectives
  cannot be captured; a line says so), the chunk's steps run in a loop.

The memory ladder (``train/fallback.py``; ``trainer.py:185-190``): the
calibration and every step run through a ``Ladder`` over the generator,
the critic and both optimizers.  A step that runs out of device memory
is rolled back and run again on the next rung (``--remat``, then
``--gp-chunked``, then ``--remat-blocks``), on the same inputs and
draws; the rung stays on ``cfg`` for the later scales.  Under
``--scan-steps K`` on the card the escalation closes the scale's
``StepGraph`` (its pool freed) and a new one starts on the new rung: an
eager step, then a fresh capture.

``--compile-ahead`` (``train/precompile.py``; ``trainer.py:176-189,
346-352``), in the file form: once a scale's first chunk has returned,
a thread builds the next scale's generator, critic, optimizers and
device cache, and at a later chunk boundary (or at the next scale's
start) this thread warms them up and, on the card under
``--scan-steps``, captures the next scale's ``StepGraph``
(``prime_ahead``); the next ``train_scale`` takes that state before its
calibration, with the values the scale would have started from (event
``"ahead"``, -1, ``{"seconds", "prime_seconds", "captured",
"graph_pool_bytes", "launches"}``), and returns the adopted generator.
Every step takes the amps as an f32 tensor in its inputs
(``iteration_inputs``), which a graph captured before the calibration
reads at each replay.
"""
from __future__ import annotations

import logging
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
from ..utils.profiling import StepTimer, span
from ..utils.saver import load_critic, load_mid_critic, load_mid_optimizers
from ..utils.tools import create_progressbar, seeded_generator
from ..utils.watchdog import Watchdog
from .fallback import Ladder
from .graphs import StepGraph
from .optim import build_d_optimizer, build_g_optimizer, freeze_frozen
from .precompile import prime_ahead, start_ahead, take_ahead
from .steps import calibrate, gan_draws, gan_step, vae_step

__all__ = ["train_scale", "scale_step", "iteration_inputs"]


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


def scale_step(cfg, G, D, opt_g, opt_d, batches, gan_phase: bool
               ) -> Callable[[dict], dict]:
    """One step of the scale on an iteration's inputs (``iteration_inputs``:
    its batch, or the device cache's rows gathered by ``batches``, its
    amps and every draw); the same function whether it runs eagerly or is
    captured in a CUDA graph, for this scale or ahead
    (``train/precompile.py``)."""
    cache = hasattr(batches, "gather")

    def run_step(inp: dict) -> dict:
        if cache:
            real, real_zero = batches.gather(inp["idx"], inp["flip"])
        else:
            real, real_zero = inp["real"], inp["real_zero"]
        if gan_phase:
            return gan_step(G, D, opt_g, opt_d, cfg, real, real_zero,
                            inp["noise_init"], inp["amps"],
                            noises=inp["noises"], eps=inp["eps"],
                            alpha=inp["alpha"], latents=inp["latents"])
        return vae_step(G, opt_g, cfg, real, real_zero, inp["amps"],
                        eps=inp["eps"])
    return run_step


def iteration_inputs(cfg, G, gan_phase: bool, source: dict, rz_shape,
                     amps: torch.Tensor, draw: torch.Generator) -> dict:
    """An iteration's inputs: its batch source, the amps (an f32 tensor
    on the device, so a captured step reads them) and its draws from
    ``draw``, in the order the step consumes them."""
    inp = dict(source, amps=amps)
    if gan_phase:
        noise_init = torch.randn(_z_init_shape(cfg, G), generator=draw,
                                 device=G.device)
        inp.update(noise_init=noise_init,
                   **gan_draws(G, noise_init, rz_shape, generator=draw))
    else:
        inp["eps"] = G.draw_eps(rz_shape, draw)
    return inp


def _calibrate_amp(cfg, G, real, real_zero, scale_idx: int,
                   draw: Callable[[], torch.Generator],
                   ladder: Callable) -> Optional[torch.Tensor]:
    """This scale's amp into ``cfg.Noise_Amps`` (``trainer.py:239-261``);
    returns the calibration's rmse, or None when none ran.  ``draw()``
    makes the calibration's generator, afresh for each attempt of the
    ``ladder``."""
    if len(cfg.Noise_Amps) >= scale_idx + 1:
        # a resume inside an already calibrated scale reuses its amp
        # (the JAX package's fix of the reference's re-append)
        return None
    if cfg.const_amp or scale_idx == 0:
        cfg.Noise_Amps.append(1.0)
        return None
    cfg.Noise_Amps.append(0.0)
    rmse = ladder(lambda: calibrate(G, real, real_zero, cfg.Noise_Amps,
                                    generator=draw()))
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
    if callback is not None:
        callback = _spanned(callback)
    if dataset is not None and saver is None:
        raise ValueError("training from a dataset needs a saver")
    scale_idx = cfg.scale_idx
    dev = G.device
    gan_phase = cfg.vae_levels < scale_idx + 1
    seed = int(cfg.manualSeed or 0) if seed is None else int(seed)
    mesh = G.mesh
    if mesh is not None:
        _check_mesh_shapes(cfg, G, mesh)
    ahead = None
    if dataset is not None and cfg.compile_ahead:
        # the state readied during the previous scale, with G's values
        ahead = take_ahead(cfg, scale_idx, G)
        if ahead is not None:
            G = ahead.G
            if callback is not None:
                callback("ahead", -1, ahead.info())
    # the reference clips over every generator parameter, frozen or not
    # (--fast-grads freezes the plan's frozen groups below)
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
        if ahead is not None:   # its init, adopted
            D = ahead.D
        else:
            D = make_discriminator(cfg.discriminator, cfg, G.ndim)
            D.reset_parameters(torch.Generator().manual_seed(
                seed * 1000 + 101 + scale_idx))
            D.to(dev)
            attach(D, mesh)
        if mid is not None:
            load_mid_critic(D, mid)
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
        opt_d = ahead.opt_d if ahead is not None else \
            build_d_optimizer(cfg, D)
    opt_g = ahead.opt_g if ahead is not None else \
        build_g_optimizer(cfg, G, scale_idx)
    if mid is not None:
        load_mid_optimizers(mid, cfg, G, opt_g, D, opt_d)
    if cfg.fast_grads:   # differentiate the plan's trainable groups only
        freeze_frozen(cfg, G, scale_idx)

    if ahead is not None and ahead.loader is not None:
        batches = ahead.loader
    elif dataset is not None:
        batches = make_loader(dataset, cfg, seed, scale_idx, dev,
                              start_iteration=start_it)
    # the device-resident cache: steps take its rows and gather on the card
    cache = hasattr(batches, "gather")
    scan_k = max(1, int(cfg.scan_steps))
    bar = create_progressbar(
        total=cfg.niter, initial=start_it,
        desc=f"Training scale [{scale_idx + 1}/{cfg.stop_scale + 1}]")
    timer = StepTimer(sync_every=max(50, scan_k), device=dev)
    watchdog = Watchdog(cfg.watchdog,
                        context=f"scale {scale_idx} start").start()
    save_interval = int(cfg.save_interval)
    history = []
    profiler = None
    # under a mesh rank 0 alone traces: the ranks would share the path
    profile_done = not cfg.profile_dir or not multihost.is_primary()
    # every rank of a mesh samples (the forwards are collectives); the
    # ranks without a summary write nothing
    visualize = cfg.visualize and (summary is not None or mesh is not None)
    amps = amps_t = None
    run_step = scale_step(cfg, G, D, opt_g, opt_d, batches, gan_phase)
    # the next scale's state is readied once this scale's first chunk
    # has returned (its own capture done)
    ahead_due = dataset is not None and cfg.compile_ahead

    def inputs_of(it: int, source: dict, rz_shape) -> dict:
        """Iteration ``it``'s inputs, its draws from ``(seed, scale,
        it)``."""
        with span("train.inputs"):
            return iteration_inputs(
                cfg, G, gan_phase, source, rz_shape, amps_t,
                seeded_generator(seed, scale_idx, it, device=dev))

    def next_source() -> dict:
        if cache:
            idxs, flips = batches.draw(1)
            return dict(zip(("idx", "flip"),
                            batches.rows(idxs[0], flips[0])))
        return dict(zip(("real", "real_zero"),
                        (_on(t, dev) for t in next(batches))))

    def batch_of(source: dict):
        if cache:
            return batches.gather(source["idx"], source["flip"])
        return source["real"], source["real_zero"]

    def new_graph():
        return StepGraph(run_step, dev,
                         modules=[G] + ([D] if D is not None else []))

    closed_replays = [0]   # of the graphs an escalation closed

    def on_escalate():
        """A new rung: the scale's graph starts again (eager, capture)."""
        nonlocal graph
        if graph is not None:
            closed_replays[0] += graph.replays
            graph.close()
            graph = new_graph()

    def replays_so_far() -> int:
        return closed_replays[0] + (graph.replays if graph is not None
                                    else 0)

    def step_of(inp: dict) -> dict:
        return graph(inp) if graph is not None else run_step(inp)

    ladder = Ladder(cfg, scale_idx, (G, D), (opt_g, opt_d), mesh=mesh,
                    on_escalate=on_escalate)
    graph = None
    if scan_k > 1 and dev.type == "cuda":
        if mesh is None:
            graph = (ahead.graph if ahead is not None
                     and ahead.graph is not None else new_graph())
        elif not getattr(cfg, "_scan_mesh_noted", False):   # once a run
            cfg._scan_mesh_noted = True
            logging.info(f"--scan-steps {scan_k} under a mesh: the chunks' "
                         f"steps run eagerly (the gloo collectives of ranks "
                         f"sharing a card cannot be captured in a CUDA "
                         f"graph)")
    try:
        # the scale's first batch: the calibration's, and the first step's
        # unless a chunk of k > 1 starts the scale on the cache (its rows
        # then start one later, as the JAX trainer's loader.draw follows
        # its next(); PARITY.md deviation 10)
        it = start_it
        if it < cfg.niter:
            first = next_source()
            real, real_zero = batch_of(first)
            rmse = _calibrate_amp(
                cfg, G, real, real_zero, scale_idx,
                lambda: seeded_generator(seed, scale_idx, device=dev),
                ladder)
            if rmse is not None and callback is not None:
                callback("calibrate", -1, {"rmse": rmse,
                                           "noise_amp": cfg.Noise_Amps[-1]})
            amps = list(cfg.Noise_Amps)
            amps_t = torch.tensor(amps, dtype=torch.float32, device=dev)
            rz_shape = tuple(real_zero.shape)
        while it < cfg.niter:
            # the trace window starts and ends at chunk boundaries
            if not profile_done and profiler is None and it >= 5:
                profiler, profile_start = _start_profiler(dev), it
            elif profiler is not None and it >= profile_start + 10:
                _stop_profiler(profiler, cfg.profile_dir, scale_idx)
                profiler, profile_done = None, True
            k = min(scan_k, cfg.niter - it)
            if cfg.visualize and cfg.print_interval > 0:   # keep cadence
                boundary = (it // cfg.print_interval + 1) * cfg.print_interval
                k = max(1, min(k, boundary - it))
            replays = replays_so_far()
            with span("train.chunk"):
                if cache and k > 1:
                    idxs, flips = batches.draw(k)
                    sources = [dict(zip(("idx", "flip"),
                                        batches.rows(idxs[j], flips[j])))
                               for j in range(k)]
                else:
                    sources = [first if it + j == start_it
                               else next_source() for j in range(k)]
                chunk = []
                for j, source in enumerate(sources):
                    inp = inputs_of(it + j, source, rz_shape)
                    chunk.append(ladder(step_of, inp))
            if ahead_due:
                ahead_due = False
                start_ahead(cfg, G, dataset, scale_idx + 1, seed)
            elif dataset is not None and cfg.compile_ahead:
                prime_ahead(cfg)   # once the thread has built the state
            last = it + k - 1
            bar.update(k)
            timer.step(n=k)
            watchdog.beat(f"scale {scale_idx} iteration {last + 1}")
            if saver is not None and save_interval > 0 and \
                    it + k < cfg.niter and \
                    (it + k) // save_interval > it // save_interval:
                watchdog.beat(f"scale {scale_idx} mid checkpoint "
                              f"(iteration {it + k})")
                saver.save_checkpoint(
                    {"scale": scale_idx, "iteration": it + k,
                     "gvars": G.state_dict(), "opt_g": opt_g.state_dict(),
                     "dvars": D.state_dict() if gan_phase else {},
                     "opt_d": opt_d.state_dict() if gan_phase else {},
                     "noise_amps": list(cfg.Noise_Amps)}, "netG_mid")
            bar.set_description(
                f"Scale [{scale_idx + 1}/{cfg.stop_scale + 1}], "
                f"Iteration [{last + 1}/{cfg.niter}]" + timer.suffix)
            if dataset is None:
                history.extend(chunk)
            if callback is not None and scan_k > 1:
                callback("chunk", it, {
                    "k": k,
                    "replays": replays_so_far() - replays,
                    "graph_pool_bytes": (graph.pool_bytes
                                         if graph is not None else 0)})
            if summary is not None and cfg.visualize:
                # one device-to-host copy for the chunk's scalars
                names = sorted(chunk[0])
                host = torch.stack([torch.stack([m[n].float() for n in names])
                                    for m in chunk]).cpu().tolist()
                for j, row in enumerate(host):
                    _write_scalars(summary, scale_idx, it + j,
                                   cfg.Noise_Amps[scale_idx],
                                   dict(zip(names, row)), gan_phase)
            if callback is not None:
                for j, metrics in enumerate(chunk):
                    callback("step", it + j, metrics)
            if visualize and it % cfg.print_interval == 0:
                # the chunk's last batch, as the JAX trainer's
                real, real_zero = batch_of(sources[-1])
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
            it += k
    except BaseException:
        # the checkpoints below never run on this path: disarm the
        # watchdog so it cannot end a process that handles the error
        watchdog.stop()
        raise
    finally:
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir, scale_idx)
        if graph is not None:
            graph.close()
        if dataset is not None:
            batches.close()
        bar.close()
        # the next scale's plan starts from a generator that trains whole
        G.requires_grad_(True)

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


def _spanned(callback: Callable[[str, int, dict], None]
             ) -> Callable[[str, int, dict], None]:
    """``callback`` inside the span ``train.callback``: the caller's own
    time between the trainer's steps."""
    def call(event: str, it: int, info: dict) -> None:
        with span("train.callback"):
            callback(event, it, info)
    return call


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


def _on(t, dev) -> torch.Tensor:
    """A batch array or tensor as an f32 tensor on ``dev``."""
    return torch.as_tensor(t, dtype=torch.float32, device=dev)


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
