"""Checkpoint loading + samplers (port of ``hpvaegan_tpu/serving.py:32-279``).

``SamplerSession`` loads a trained generator once and serves rand-mode and
rec-mode batches on the card.  PyTorch runs eagerly, so there is no
per-shape compile to pay: ``warmup`` builds the kernels and settles the
allocator and cuDNN's first-call set-up instead.

One forced difference from the JAX package: the pyramid geometry.  The
JAX session decodes the source video with OpenCV only to learn its aspect
ratio and frame rate (``hpvaegan_tpu/serving.py:127-133``,
``data/video.py:67-72``).  The machine with the card has no OpenCV, so the
port's session reads ``ar`` and ``org_fps`` from the experiment's
``config.json`` beside the checkpoint, where training wrote them
(``Config.snapshot_dict``).  The video itself is not opened, and rec mode
takes the real zero-scale clip as an array.

A snapshot with ``bf16: true`` samples in bf16 (the generator reads
``cfg.bf16``), as the JAX session does; the JAX sampler returns that bf16
array, and numpy has no bf16, so the port returns the same values as
float32.

It serves 3D ``GeneratorHPVAEGAN`` checkpoints in the port's own format
and the JAX package's flax-msgpack ``netG`` (``utils/saver.py``
``restore_generator`` tells them apart by their first byte); the 2D image
path, the baselines and extrapolated (``h/w/t_factor``) sampling are
ROADMAP items.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
from functools import reduce
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .core.config import Config
from .models.registry import make_generator
from .utils.saver import restore_generator

__all__ = ["SNAPSHOT_KEYS", "apply_snapshot", "config_from_cli_args",
           "explicit_cli_keys", "read_geometry", "SamplerSession"]


def config_from_cli_args(args) -> Config:
    """Overlay parsed CLI args onto a fresh Config (shared by the generate
    and serve entry points — one place owns the sampling_rates tuple
    coercion and any future special case)."""
    cfg = Config()
    for key, value in vars(args).items():
        attr = key.replace("-", "_")
        if hasattr(cfg, attr):
            setattr(cfg, attr, tuple(value) if attr == "sampling_rates"
                    else value)
    return cfg


def explicit_cli_keys(build_parser, argv=None) -> set:
    """Which dest names were explicitly present on the command line (parse
    with every default suppressed).  ``build_parser`` must be the SAME
    parser factory the CLI parsed its args with."""
    p = build_parser()
    for action in p._actions:
        action.default = argparse.SUPPRESS
        action.required = False
    return set(vars(p.parse_args(argv)).keys())


# training-time keys restored from the experiment's config.json snapshot
# (written at train start); any flag the user passes explicitly wins
SNAPSHOT_KEYS = (
    "generator", "nc_im", "nfc", "latent_dim", "vae_levels", "enc_blocks",
    "ker_size", "num_layer", "padd_size", "scale_factor", "noise_amp",
    "min_size", "max_size", "img_size", "sampling_rates", "stop_scale_time",
    "start_frame", "max_frames", "train_all", "bf16",
    "video_path", "image_path",
)


def _snapshot_path(netG: str) -> str:
    return os.path.join(os.path.dirname(netG), "config.json")


def apply_snapshot(cfg: Config, netG: str, explicit: set,
                   user_chose_source: bool) -> list:
    """Overlay the experiment's resolved config.json snapshot onto ``cfg``.

    ``explicit`` holds dest names the user passed on the command line (they
    win over the snapshot); ``user_chose_source`` suppresses the snapshot's
    video/image path when the user picked a source clip/image themselves.
    Returns the list of applied keys (empty when no snapshot exists).
    """
    snap_path = _snapshot_path(netG)
    if not os.path.isfile(snap_path):
        return []
    with open(snap_path) as f:
        snap = json.load(f)
    applied = []
    for key in SNAPSHOT_KEYS:
        if key not in snap or key in explicit:
            continue
        if key in ("video_path", "image_path") and user_chose_source:
            continue
        value = snap[key]
        if key == "sampling_rates":
            value = tuple(value)
        # the snapshot is written AFTER adjust_scales: restore the
        # pre-adjust inputs so re-adjusting reproduces the training
        # pyramid exactly
        elif key == "scale_factor":
            value = snap.get("scale_factor_init", value)
        elif key == "noise_amp":
            value = snap.get("noise_amp_init", value)
        setattr(cfg, key, value)
        applied.append(key)
    if applied:
        logging.info(f"config.json snapshot: restored {applied} "
                     f"from {snap_path}")
    return applied


def read_geometry(netG: str):
    """``(ar, org_fps)`` of the training clip, from the ``config.json``
    beside ``netG`` (see the module docstring)."""
    snap_path = _snapshot_path(netG)
    if not os.path.isfile(snap_path):
        raise RuntimeError(
            f"no {snap_path}: the port reads the clip's aspect ratio and "
            f"frame rate from the training config.json snapshot")
    with open(snap_path) as f:
        snap = json.load(f)
    missing = [k for k in ("ar", "org_fps") if k not in snap]
    if missing:
        raise RuntimeError(f"{snap_path} lacks {missing}")
    return float(snap["ar"]), float(snap["org_fps"])


class SamplerSession:
    """A loaded checkpoint with rand/rec samplers on ``device``.

    ``cfg`` must already have the snapshot applied and ``adjust_scales()``
    called by the caller (the CLIs own flag parsing); the session owns the
    geometry, the model and the samplers.  ``device`` defaults to the card
    and raises when there is none.
    """

    def __init__(self, cfg: Config, *, batch_size: int = 2,
                 manual_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        if not cfg.video_path and not cfg.image_path:
            raise RuntimeError(
                "no source clip/image configured: pass --video-path/"
                "--image-path, or keep the training config.json snapshot "
                "next to the --netG checkpoint")
        if not cfg.video_path:
            raise NotImplementedError(
                "2D image sampling is not ported yet: ROADMAP Queue 1 item 5")
        self.ndim = 3

        if not os.path.isfile(cfg.netG):
            raise RuntimeError(f"=> no <G> checkpoint found at '{cfg.netG}'")
        cfg.ar, cfg.org_fps = read_geometry(cfg.netG)
        cfg.fps_lcm = reduce(math.lcm, cfg.sampling_rates)
        pyramid = cfg.pyramid()

        # weights are built and loaded on the CPU, then moved: the growth
        # replay's stage init draws from a CPU generator either way
        init_gen = torch.Generator().manual_seed(manual_seed)
        G = make_generator(cfg.generator, cfg, pyramid, ndim=self.ndim)
        G.init(init_gen)
        raw = restore_generator(cfg.netG, G, init_gen)
        self.scale = int(raw["scale"])
        cfg.scale_idx = self.scale
        self.G = G.to(self.device)
        self.pyramid = pyramid
        self.amps = [float(a) for a in raw["noise_amps"]]
        self.generator = torch.Generator(device=self.device).manual_seed(
            manual_seed)

        t0, h0, w0 = pyramid.shape3d(0)
        self.noise_shape = (self.batch_size, t0, h0, w0, cfg.latent_dim)

    # ---- convenience entry points (one batch each) ----

    def sample_batch(self, generator: Optional[torch.Generator] = None
                     ) -> np.ndarray:
        """One rand-mode batch, NTHWC in [-1, 1], float32 (holding bf16
        values under ``bf16``): draw the latent noise, run the pyramid
        (BatchNorm on batch statistics, as in training)."""
        g = self.generator if generator is None else generator
        with torch.inference_mode():
            noise = torch.randn(self.noise_shape, generator=g,
                                device=self.device)
            out, _, _ = self.G.apply(self.amps, noise_init=noise,
                                     mode="rand", train=True, generator=g)
            return out.float().cpu().numpy()

    def reconstruct_batch(self, real_zero: np.ndarray,
                          generator: Optional[torch.Generator] = None
                          ) -> np.ndarray:
        """One rec-mode batch from the real zero-scale clip ``real_zero``
        ((T,H,W,3) for one clip, repeated to the batch, or a batch)."""
        real_zero = np.asarray(real_zero, np.float32)
        if real_zero.ndim == 4:
            real_zero = np.stack([real_zero] * self.batch_size)
        g = self.generator if generator is None else generator
        with torch.inference_mode():
            out, _, _ = self.G.apply(self.amps, real_zero=real_zero,
                                     mode="rec", train=True, generator=g)
            return out.float().cpu().numpy()

    def warmup(self, modes=("rand",)) -> None:
        """Run one batch per mode before serving (kernel build, allocator,
        cuDNN set-up).  Unknown mode strings raise."""
        for mode in modes:
            g = torch.Generator(device=self.device).manual_seed(999983)
            if mode == "rand":
                self.sample_batch(g)
            elif mode == "rec":
                t0, h0, w0 = self.pyramid.shape3d(0)
                self.reconstruct_batch(
                    np.zeros((t0, h0, w0, self.cfg.nc_im), np.float32), g)
            else:
                raise ValueError(f"unknown warmup mode {mode!r} (rand|rec)")
