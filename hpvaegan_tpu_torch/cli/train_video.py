"""Progressive multi-scale 3D HP-VAE-GAN training on one video (port of
``hpvaegan_tpu/cli/train_video.py:27-109``; reference train_video.py:261-421).

    python -m hpvaegan_tpu_torch.cli.train_video --video-path data/vids/wingsuit.avi \\
        --niter 2 --pconv --pconv-all --pfuse --manualSeed 0

Per scale the dataset takes that scale's resolution and frame rate, then
``train_scale`` runs the VAE or the WGAN-GP phase.  The clip must have
been decoded once into its frames file (``python -m
hpvaegan_tpu_torch.tools.decode_frames <clip>``).  It trains on the card;
``--no-cuda`` trains on the CPU with the kernels' plain versions.  The
flags are the JAX CLI's; a flag whose feature the port does not have yet
raises, naming its ROADMAP item, instead of being ignored.  As in the JAX
CLI, every run opens an event file in its experiment directory
(``utils/summaries.py``), which ``--visualize`` fills with the scalars
and sample grids; ``--profile-dir`` writes a ``torch.profiler`` trace per
scale.

Sharded training (``hpvaegan_tpu/cli/train_video.py:31-49``,
``train/trainer.py:129-140``): ``--spmd --mesh-shape DxS`` trains over a
(data, spatial) mesh of D*S ranks, the batch split over data and H over
spatial (``parallel/mesh.py``), the 64 -> 64 convs on K4.

* ``--distributed``: this process is one rank of a launch described by
  the environment (``HPVAEGAN_COORDINATOR`` host:port,
  ``HPVAEGAN_NUM_PROCESSES``, ``HPVAEGAN_PROCESS_ID``; see
  ``parallel/distributed.py``); ranks may share a card, and then talk
  over gloo;
* without it, the command starts the D*S ranks itself on this host, as
  fresh interpreters, one a card (``--no-cuda``: gloo CPU ranks), and
  raises when the host has fewer cards than mesh positions.

``--spmd`` without ``--mesh-shape``, or ``--mesh-shape`` without
``--spmd``, trains in one process, as in the JAX package.  The seed and
the run id are agreed between the ranks, and only rank 0 writes the
experiment tree, the event file and the logbook.
"""
from __future__ import annotations

import logging
import math
import os
import random
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from .. import resolve_device
from ..core.config import build_parser, config_from_args
from ..data.video import SingleVideoDataset
from ..models.registry import make_generator
from ..parallel import make_mesh, maybe_initialize, multihost, replicate
from ..parallel.distributed import LAUNCHER_VARS, backend
from ..parallel.mesh import parse_mesh_shape
from ..train.trainer import train_scale
from ..utils.logger import LoggingBlock, configure_logging
from ..utils.saver import VideoSaver, apply_resume
from ..utils.summaries import TensorboardSummary
from ..utils.tools import seeded_generator

__all__ = ["main", "check_ported", "spawn_ranks"]

# flag -> (is it asked for?, where its feature waits)
_UNPORTED = {
    "--scan-steps > 1": (lambda c: int(c.scan_steps) > 1,
                         "ROADMAP Queue 1 item 9 (CUDA graphs)"),
    "--fast-grads": (lambda c: c.fast_grads, "ROADMAP Queue 1 item 9"),
    "--fused-forwards": (lambda c: c.fused_forwards,
                         "ROADMAP Queue 1 item 9"),
    "--hoist-prefix": (lambda c: c.hoist_prefix, "ROADMAP Queue 1 item 9"),
    "--remat": (lambda c: c.remat, "ROADMAP Queue 1 item 8"),
    "--remat-blocks": (lambda c: c.remat_blocks, "ROADMAP Queue 1 item 8"),
    "--gp-chunked": (lambda c: c.gp_chunked, "ROADMAP Queue 1 item 8"),
    "--compile-ahead": (lambda c: c.compile_ahead,
                        "ROADMAP Queue 1 item 13"),
    "--wpack": (lambda c: c.wpack,
                "a TPU lane-packing route, ROADMAP Queue 1 item 13"),
}


def check_ported(cfg) -> None:
    """Raise for every flag asked for whose feature the port lacks."""
    asked = [f"{flag} ({where})" for flag, (on, where) in _UNPORTED.items()
             if on(cfg)]
    if asked:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(asked))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: Sequence[str], n: int, no_cuda: bool,
                poll_s: float = 0.2,
                module: str = "hpvaegan_tpu_torch.cli.train_video") -> None:
    """Run the CLI ``module`` (this one by default) as ``n`` ranks on this
    host: fresh interpreters given ``argv`` plus ``--distributed`` and the
    launcher's environment, one a card (gloo CPU ranks under
    ``--no-cuda``, which share the host's cores unless
    ``OMP_NUM_THREADS`` says otherwise).  Waits for all; when one fails
    the others are stopped and RuntimeError names it."""
    if not no_cuda:
        resolve_device("cuda")
        cards = torch.cuda.device_count()
        if cards < n:
            raise ValueError(
                f"the mesh has {n} positions and this host {cards} CUDA "
                f"card(s): the local launch starts one rank a card; start "
                f"the ranks yourself with --distributed (ranks may then "
                f"share a card, over gloo)")
    root = str(Path(__file__).resolve().parents[2])
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, **dict(zip(
                LAUNCHER_VARS, (coordinator, str(n), str(rank)))))
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in [env.get("PYTHONPATH")] if p])
            if no_cuda:
                env.setdefault("OMP_NUM_THREADS",
                               str(max(1, (os.cpu_count() or 1) // n)))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--distributed"],
                env=env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {n} exited with "
                                   f"code {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main(argv: Optional[Sequence[str]] = None,
         callback: Optional[Callable[[int, str, int, dict], None]] = None):
    """Train every scale; returns the run's config.  ``callback(scale,
    event, iteration, info)`` sees each scale's calibration and steps (as
    ``train_scale``'s callback, with the scale).  ``--spmd --mesh-shape``
    without ``--distributed`` starts the ranks (``spawn_ranks``) and
    returns the parsed config once they are done; the callback then sees
    nothing."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = config_from_args(build_parser("video").parse_args(argv))
    check_ported(cfg)
    sharded = bool(cfg.spmd and cfg.mesh_shape)
    if sharded and not cfg.distributed:
        shape = parse_mesh_shape(cfg.mesh_shape)
        spawn_ranks(argv, math.prod(shape), cfg.no_cuda)
        return cfg
    device = resolve_device("cpu" if cfg.no_cuda else "cuda")
    rank, world = maybe_initialize(cfg.distributed, device_type=device.type)
    if cfg.distributed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    assert cfg.vae_levels > 0
    assert cfg.disc_loss_weight > 0
    # one seed and one experiment directory for the whole launch
    if cfg.manualSeed is None:
        cfg.manualSeed = random.randint(1, 10000)
    cfg.manualSeed = multihost.agree(cfg.manualSeed)

    saver = VideoSaver(cfg)
    primary = multihost.is_primary()
    configure_logging(os.path.join(saver.experiment_dir, "logbook.txt")
                      if primary else None)
    cfg.adjust_scales()
    logging.info(f"Random Seed: {cfg.manualSeed}")
    mesh = None
    if sharded:
        mesh = make_mesh(parse_mesh_shape(cfg.mesh_shape))
        logging.info(f"Mesh {mesh.shape} (data, spatial): rank {rank} of "
                     f"{world} at {(mesh.data_index, mesh.spatial_index)}, "
                     f"backend {backend()} on {device}")
    cfg.scale_idx = 0
    cfg.Noise_Amps = []

    dataset = SingleVideoDataset(cfg)  # reads fps/ar, level-0 frames
    pyramid = dataset.pyramid
    # the resolved config: resume and sampling rebuild the model from it
    saver.save_json(cfg.snapshot_dict(), "config.json")

    with LoggingBlock("Commandline Arguments", emph=True):
        for arg, value in sorted(vars(cfg).items()):
            if type(value) in (str, int, float, tuple, list):
                logging.info(f"{arg}: {value}")
    with LoggingBlock("Experiment Summary", emph=True):
        logging.info(f"Experiment dir: {saver.experiment_dir}")
        logging.info(f"Generator      : {cfg.generator}")
        logging.info(f"Iterations     : {cfg.niter}")
        logging.info(f"Sampling rates : {list(cfg.sampling_rates)}")
        logging.info(f"Device         : {device}")

    seed = cfg.manualSeed
    G = make_generator(cfg.generator, cfg, pyramid, ndim=3)
    G.init(seeded_generator(seed, 7)).to(device)
    if mesh is not None:
        replicate(G, mesh)   # rank 0's weights, the mesh attached
    summary = TensorboardSummary(saver.experiment_dir) if primary else None
    try:
        if cfg.netG != "":
            apply_resume(cfg, G, seeded_generator(seed, 100, device=device))
        else:
            cfg.resumed_idx = -1

        while cfg.scale_idx < cfg.stop_scale + 1:
            scale = cfg.scale_idx
            if scale > 0 and cfg.resumed_idx != scale:
                G.init_next_stage(seeded_generator(seed, 100 + scale,
                                                   device=device))
            # per-scale dataset regeneration (train_video.py:25-36)
            cfg.fps = pyramid.fps(scale)
            cfg.td = pyramid.td(scale)
            cfg.fps_index = pyramid.fps_index(scale)
            with LoggingBlock("Updating dataset", emph=True):
                logging.info(f"FPS : {cfg.fps}")
                logging.info(f"Time-Depth : {cfg.td}")
                logging.info(
                    f"Sampling-Ratio : {cfg.sampling_rates[cfg.fps_index]}")
                dataset.generate_frames(scale)
            if cfg.decode_ahead and scale < cfg.stop_scale:
                dataset.prefetch_frames(scale + 1)

            hook = None
            if callback is not None:
                def hook(event, it, info, scale=scale):
                    callback(scale, event, it, info)
            train_scale(cfg, G, dataset=dataset, saver=saver,
                        summary=summary, callback=hook)
            cfg.scale_idx += 1
    finally:
        saver.wait()   # a write queued before an error still lands
        if summary is not None:
            summary.close()
    return cfg


if __name__ == "__main__":
    main()
