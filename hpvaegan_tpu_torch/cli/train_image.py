"""Progressive multi-scale 2D HP-VAE-GAN training on one image or a
directory of images (port of ``hpvaegan_tpu/cli/train_image.py:27-123``;
reference train_image.py:275-445).

    python -m hpvaegan_tpu_torch.cli.train_image --image-path photo.png \\
        --niter 2 --manualSeed 0

The outer loop grows the generator one scale at a time; ``train_scale``
runs the VAE phase below ``--vae-levels`` and the WGAN-GP phase above
it.  A PNG is read directly; another format must have been decoded once
into its frames file (``python -m hpvaegan_tpu_torch.tools.decode_frames
<image>``).  It trains on the card; ``--no-cuda`` trains on the CPU.
The flags are the JAX CLI's: the fast path's (``--fast-grads``,
``--scan-steps``, the device-resident cache unless ``--host-loader``)
train as in ``cli/train_video.py``, the memory ladder's (``--remat``,
``--gp-chunked``, ``--remat-blocks``, and the automatic escalation) and
``--wpack`` (the 2D stages and critic over packed W, ``models/packed.py``)
too, ``--compile-ahead`` readies each next scale ahead as there
(``train/precompile.py``); ``--spmd --mesh-shape DxS`` trains over a
mesh as there.
The 2D models hold no TPU kernel: every conv runs on stock PyTorch ops.

With ``--tag`` and ``$NEPTUNE_PROJECT`` set and the neptune client
importable, the scalars and grids go to neptune instead of the event
file, as in the JAX CLI (reference train_image.py:31-36, 346-348).
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
from ..data.image import MultipleImageDataset, SingleImageDataset
from ..models.registry import make_generator
from ..parallel import make_mesh, maybe_initialize, multihost, replicate
from ..parallel.distributed import backend
from ..parallel.mesh import parse_mesh_shape
from ..train.trainer import train_scale
from ..utils.logger import LoggingBlock, configure_logging
from ..utils.saver import ImageSaver, apply_resume
from ..utils.summaries import TensorboardSummary
from ..utils.tools import seeded_generator
from .train_video import spawn_ranks

__all__ = ["main"]


def _neptune_experiment(cfg):
    """The neptune experiment of ``--tag`` under ``$NEPTUNE_PROJECT``, or
    None (no tag, no project, or a client that fails to start)."""
    if not (cfg.tag and os.environ.get("NEPTUNE_PROJECT")):
        return None
    try:
        import neptune
        neptune.init(project_qualified_name=os.environ["NEPTUNE_PROJECT"])
        return neptune.create_experiment(
            name=cfg.checkname, params=vars(cfg), tags=[cfg.tag]
        ).__enter__()
    except Exception as e:  # unavailable client/network: fall back to TB
        logging.warning(f"neptune disabled: {e}")
        return None


def main(argv: Optional[Sequence[str]] = None,
         callback: Optional[Callable[[int, str, int, dict], None]] = None):
    """Train every scale; returns the run's config.  ``callback(scale,
    event, iteration, info)`` sees each scale's calibration and steps, as
    in ``cli/train_video.main``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = config_from_args(build_parser("image").parse_args(argv))
    sharded = bool(cfg.spmd and cfg.mesh_shape)
    if sharded and not cfg.distributed:
        spawn_ranks(argv, math.prod(parse_mesh_shape(cfg.mesh_shape)),
                    cfg.no_cuda, module="hpvaegan_tpu_torch.cli.train_image")
        return cfg
    device = resolve_device("cpu" if cfg.no_cuda else "cuda")
    rank, world = maybe_initialize(cfg.distributed, device_type=device.type)
    if cfg.distributed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    assert cfg.vae_levels > 0
    assert cfg.disc_loss_weight > 0
    # reference clamp (train_image.py:339-340): images repeat to >= batch
    if cfg.data_rep < cfg.batch_size:
        cfg.data_rep = cfg.batch_size
    if cfg.manualSeed is None:
        cfg.manualSeed = random.randint(1, 10000)
    cfg.manualSeed = multihost.agree(cfg.manualSeed)

    saver = ImageSaver(cfg)
    primary = multihost.is_primary()
    neptune_exp = _neptune_experiment(cfg) if primary else None
    summary = (TensorboardSummary(saver.experiment_dir,
                                  neptune_exp=neptune_exp)
               if primary else None)
    configure_logging(os.path.join(saver.experiment_dir, "logbook.txt")
                      if primary else None)
    try:
        cfg.adjust_scales()
        logging.info(f"Random Seed: {cfg.manualSeed}")
        mesh = None
        if sharded:
            mesh = make_mesh(parse_mesh_shape(cfg.mesh_shape))
            logging.info(f"Mesh {mesh.shape} (data, spatial): rank {rank} "
                         f"of {world} at "
                         f"{(mesh.data_index, mesh.spatial_index)}, backend "
                         f"{backend()} on {device}")
        cfg.scale_idx = 0
        cfg.Noise_Amps = []

        if os.path.isdir(cfg.image_path):
            dataset = MultipleImageDataset(cfg)
        else:
            dataset = SingleImageDataset(cfg)
        pyramid = dataset.pyramid
        # the resolved config: resume and sampling rebuild the model from it
        saver.save_json(cfg.snapshot_dict(), "config.json")

        with LoggingBlock("Commandline Arguments", emph=True):
            for arg, value in sorted(vars(cfg).items()):
                if type(value) in (str, int, float, tuple, list):
                    logging.info(f"{arg}: {value}")
        with LoggingBlock("Experiment Summary", emph=True):
            logging.info(f"Experiment dir: {saver.experiment_dir}")
            logging.info(f"Generator  : {cfg.generator}")
            logging.info(f"Iterations : {cfg.niter}")
            logging.info(f"Device     : {device}")

        seed = cfg.manualSeed
        G = make_generator(cfg.generator, cfg, pyramid, ndim=2)
        G.init(seeded_generator(seed, 7)).to(device)
        if mesh is not None:
            replicate(G, mesh)   # rank 0's weights, the mesh attached
        if cfg.netG != "":
            apply_resume(cfg, G, seeded_generator(seed, 100, device=device))
        else:
            cfg.resumed_idx = -1

        while cfg.scale_idx < cfg.stop_scale + 1:
            scale = cfg.scale_idx
            if scale > 0 and cfg.resumed_idx != scale:
                G.init_next_stage(seeded_generator(seed, 100 + scale,
                                                   device=device))
            hook = None
            if callback is not None:
                def hook(event, it, info, scale=scale):
                    callback(scale, event, it, info)
            # under --compile-ahead, the generator readied ahead
            G = train_scale(cfg, G, dataset=dataset, saver=saver,
                            summary=summary, callback=hook)[0]
            cfg.scale_idx += 1
    finally:
        saver.wait()   # a write queued before an error still lands
        if summary is not None:
            summary.close()
        # finalize the neptune experiment (the reference relies on the
        # legacy client's atexit flush and never stops it)
        if neptune_exp is not None:
            try:
                neptune_exp.stop()
            except Exception as e:
                logging.warning(f"neptune experiment stop failed: {e}")
    return cfg


if __name__ == "__main__":
    main()
