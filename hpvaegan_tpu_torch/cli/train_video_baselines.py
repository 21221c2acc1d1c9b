"""The pure-GAN video baselines (SinGAN / ConSinGAN, no VAE) on one video
(port of ``hpvaegan_tpu/cli/train_video_baselines.py:25-108``; reference
train_video_baselines.py:216-370).

    python -m hpvaegan_tpu_torch.cli.train_video_baselines \\
        --video-path data/vids/wingsuit.avi --niter 2 --pconv --pfuse

The generator is ``GeneratorCSG`` (the default) or ``GeneratorSG``; the
critic the SN ``WDiscriminator3D`` by default (the reference's default,
``train_video_baselines.py:233``), with its K1/K2 routes under
``--pconv``/``--pfuse``, or ``WDiscriminatorBaselines``.  The generator
starts with its first body stage and grows one copy a scale; each scale
runs ``train/trainer_baselines.py``.  A ``--netG`` resume replays the
growth and reloads the run's ``Z_init`` instead of drawing a new one (the
JAX package's fix of a reference resume bug).  As ``cli.train_video``:
the clip's frames file must exist, it trains on the card unless
``--no-cuda``, flags whose feature the port lacks raise
(``check_ported``), every run opens an event file, and ``--spmd
--mesh-shape Dx1`` trains over a data mesh of ranks (started here, or one
rank under ``--distributed``); a spatial mesh axis raises.
"""
from __future__ import annotations

import logging
import math
import os
import random
import sys
from typing import Callable, Optional, Sequence

import torch

from .. import resolve_device
from ..core.config import build_parser, config_from_args
from ..data.video import SingleVideoDataset
from ..models.registry import make_generator
from ..parallel import make_mesh, maybe_initialize, multihost, replicate
from ..parallel.distributed import backend
from ..parallel.mesh import parse_mesh_shape
from ..train.trainer_baselines import train_scale_baselines
from ..utils.logger import LoggingBlock, configure_logging
from ..utils.saver import VideoSaver, apply_resume, restore_file
from ..utils.summaries import TensorboardSummary
from ..utils.tools import seeded_generator
from .train_video import check_ported, spawn_ranks

__all__ = ["main"]

BASELINES = ("GeneratorCSG", "GeneratorSG")


def main(argv: Optional[Sequence[str]] = None,
         callback: Optional[Callable[[int, str, int, dict], None]] = None):
    """Train every scale; returns the run's config.  ``callback(scale,
    event, iteration, info)`` as ``cli.train_video.main``'s."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = config_from_args(build_parser("video_baselines").parse_args(argv))
    check_ported(cfg)
    if cfg.generator not in BASELINES:
        raise ValueError(f"{cfg.generator!r} is not a baseline generator "
                         f"(have {list(BASELINES)}); the HP-VAE-GAN family "
                         f"trains with cli.train_video")
    sharded = bool(cfg.spmd and cfg.mesh_shape)
    if sharded and not cfg.distributed:
        shape = parse_mesh_shape(cfg.mesh_shape)
        spawn_ranks(argv, math.prod(shape), cfg.no_cuda,
                    module="hpvaegan_tpu_torch.cli.train_video_baselines")
        return cfg
    device = resolve_device("cpu" if cfg.no_cuda else "cuda")
    rank, world = maybe_initialize(cfg.distributed, device_type=device.type)
    if cfg.distributed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

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

    dataset = SingleVideoDataset(cfg)
    pyramid = dataset.pyramid
    saver.save_json(cfg.snapshot_dict(), "config.json")

    with LoggingBlock("Commandline Arguments", emph=True):
        for arg, value in sorted(vars(cfg).items()):
            if type(value) in (str, int, float, tuple, list):
                logging.info(f"{arg}: {value}")
    with LoggingBlock("Experiment Summary", emph=True):
        logging.info(f"Experiment dir: {saver.experiment_dir}")
        logging.info(f"Generator      : {cfg.generator}")
        logging.info(f"Device         : {device}")

    seed = cfg.manualSeed
    G = make_generator(cfg.generator, cfg, pyramid, ndim=3)
    # the baselines start WITH their first body stage
    G.init(seeded_generator(seed, 7)).to(device)
    if mesh is not None:
        replicate(G, mesh)
    cfg.Z_init = None
    summary = TensorboardSummary(saver.experiment_dir) if primary else None
    try:
        if cfg.netG != "":
            apply_resume(cfg, G)   # the baselines grow without a draw
            # reload the run's fixed reconstruction noise (the reference
            # draws a new one, train_video_baselines.py:38-43)
            z_path = os.path.join(cfg.resume_dir, "Z_init")
            if os.path.exists(z_path):
                cfg.Z_init = torch.as_tensor(
                    restore_file(z_path)["data"], dtype=torch.float32,
                    device=device)
        else:
            cfg.resumed_idx = -1

        while cfg.scale_idx < cfg.stop_scale + 1:
            scale = cfg.scale_idx
            if scale > 0 and cfg.resumed_idx != scale:
                G.init_next_stage()
            cfg.fps = pyramid.fps(scale)
            cfg.td = pyramid.td(scale)
            cfg.fps_index = pyramid.fps_index(scale)
            with LoggingBlock("Updating dataset", emph=True):
                logging.info(f"FPS : {cfg.fps}")
                logging.info(f"Time-Depth : {cfg.td}")
                dataset.generate_frames(scale)
            if cfg.decode_ahead and scale < cfg.stop_scale:
                dataset.prefetch_frames(scale + 1)

            hook = None
            if callback is not None:
                def hook(event, it, info, scale=scale):
                    callback(scale, event, it, info)
            train_scale_baselines(cfg, G, dataset, saver, summary,
                                  callback=hook)
            cfg.scale_idx += 1
    finally:
        saver.wait()
        if summary is not None:
            summary.close()
    return cfg


if __name__ == "__main__":
    main()
