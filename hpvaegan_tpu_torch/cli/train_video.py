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
"""
from __future__ import annotations

import logging
import os
import random
from typing import Callable, Optional, Sequence

from .. import resolve_device
from ..core.config import build_parser, config_from_args
from ..data.video import SingleVideoDataset
from ..models.registry import make_generator
from ..train.trainer import train_scale
from ..utils.logger import LoggingBlock, configure_logging
from ..utils.saver import VideoSaver, apply_resume
from ..utils.summaries import TensorboardSummary
from ..utils.tools import seeded_generator

__all__ = ["main", "check_ported"]

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
    "--spmd": (lambda c: c.spmd, "ROADMAP Queue 1 item 12"),
    "--mesh-shape": (lambda c: bool(c.mesh_shape), "ROADMAP Queue 1 item 12"),
    "--distributed": (lambda c: c.distributed, "ROADMAP Queue 1 item 12"),
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


def main(argv: Optional[Sequence[str]] = None,
         callback: Optional[Callable[[int, str, int, dict], None]] = None):
    """Train every scale; returns the run's config.  ``callback(scale,
    event, iteration, info)`` sees each scale's calibration and steps (as
    ``train_scale``'s callback, with the scale)."""
    cfg = config_from_args(build_parser("video").parse_args(argv))
    check_ported(cfg)
    device = resolve_device("cpu" if cfg.no_cuda else "cuda")

    assert cfg.vae_levels > 0
    assert cfg.disc_loss_weight > 0
    if cfg.manualSeed is None:
        cfg.manualSeed = random.randint(1, 10000)

    saver = VideoSaver(cfg)
    configure_logging(os.path.join(saver.experiment_dir, "logbook.txt"))
    cfg.adjust_scales()
    logging.info(f"Random Seed: {cfg.manualSeed}")
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
    summary = TensorboardSummary(saver.experiment_dir)
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
        summary.close()
    return cfg


if __name__ == "__main__":
    main()
