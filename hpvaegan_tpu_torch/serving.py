"""Checkpoint loading + samplers (port of ``hpvaegan_tpu/serving.py:32-279``),
shared by the one-shot ``cli/generate.py`` and the persistent
``cli/serve.py`` server.

``SamplerSession`` loads a trained generator once and serves rand, rec
and inject batches on the card, at the training geometry or at a multiple
of it (``h/w/t_factor``: the pyramid becomes a ``ScaledPyramid``, as the
JAX session rebuilds its generator, ``serving.py:148-155``).  PyTorch runs
eagerly, so there is no per-shape compile to pay: ``warmup`` builds the
kernels and settles the allocator and cuDNN's first-call set-up instead.

One forced difference from the JAX package: the pyramid geometry.  The
JAX session decodes the source video with OpenCV only to learn its aspect
ratio and frame rate (``hpvaegan_tpu/serving.py:127-133``,
``data/video.py:67-72``).  The machine with the card has no OpenCV, so the
port's session reads ``ar`` and ``org_fps`` from the experiment's
``config.json`` beside the checkpoint, where training wrote them
(``Config.snapshot_dict``): rand sampling needs no frames at all.  The
clip's frames file (``tools/decode_frames.py``) is opened lazily, the
first time rec or inject mode needs the real clip (``dataset``,
``rec_input``).

Every sampler takes its draws from a ``torch.Generator`` on the session's
device, or explicitly (``noise``, ``noises``, ``eps``), so that tests can
feed the JAX package's draws.

A config with ``wpack`` (the snapshot's, or the caller's) samples the
refinement stages whose W is even and at least 128 over packed W
(``models/packed.py``), as the JAX session does through ``G.apply``
when its config asks.

A snapshot with ``bf16: true`` samples in bf16 (the generator reads
``cfg.bf16``), as the JAX session does; the JAX sampler returns that bf16
array, and numpy has no bf16, so the port returns the same values as
float32.  ``write_sample`` writes a clip as an uncompressed AVI
(``utils/video_io.py``; the JAX package writes MJPG through OpenCV).

A 2D session (the config names an image, no video;
``hpvaegan_tpu/serving.py:163-175, 256-266``) reads the image as the JAX
session does (``data/image.py``: a PNG directly, another format from its
frames file), which sets the aspect ratio; its samples are NHWC images,
written as PNG (``utils/saver.write_png``).

It serves every generator of the zoo, 2D and 3D, in the port's own
format and the JAX package's flax-msgpack ``netG`` (``utils/saver.py``
``restore_generator`` tells them apart by their first byte):
``GeneratorHPVAEGAN`` and ``GeneratorVAE_nb`` sample from latent-dim
noise through the decoder (rand, rec, inject), the baselines
``GeneratorCSG``/``GeneratorSG`` from image-channel noise (reference
train_video_baselines.py:41), and reconstruct from the fixed ``Z_init``
checkpointed beside ``netG`` (JAX ``serving.py:226-248``); they have no
inject mode.

``mesh_shape`` ("DxS" or "D"; JAX ``serving.py:177-182, 218-224``)
samples over a (data, spatial) mesh of ranks, one process each: every
rank joins the launch (``parallel.maybe_initialize``, from the launcher
environment, or a group already up), loads ``netG`` and replicates rank
0's weights (``parallel.replicate``, checked bit for bit).  The samplers
keep their signatures and every rank calls them alike: each draw is made
whole from the session's generator (or handed in), ``G.apply`` cuts the
rank's block (batch over data, H over spatial), and the output is
gathered whole on every rank (``Mesh.gather_whole``).  A batch that D
does not divide raises, naming both numbers.  Sampling uses the batch
statistics, which under a mesh are the whole mesh's, so the samples
equal the one-process session's within the f32 (or bf16) bar, not bit
for bit.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
from functools import reduce
from typing import Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .core.config import Config
from .core.pyramid import ScaledPyramid
from .data.image import SingleImageDataset
from .data.video import SingleVideoDataset
from .models.registry import make_generator
from .parallel import make_mesh, maybe_initialize, parse_mesh_shape, replicate
from .tools.decode_frames import frames_path
from .utils.profiling import span
from .utils.saver import restore_file, restore_generator, write_png
from .utils.video_io import write_avi

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
# (written at train start); any flag the user passes explicitly wins.
# The JAX package's keys, and ``pconv_all`` and ``wpack``: a run trained
# with --pconv-all samples with its stage convs on K1, and one trained
# with --wpack with its top stages over packed W, as it trained (the JAX
# session samples unpacked on stock convs unless its caller's config
# asks; the flags only route, the weights and the outputs are the same)
SNAPSHOT_KEYS = (
    "generator", "nc_im", "nfc", "latent_dim", "vae_levels", "enc_blocks",
    "ker_size", "num_layer", "padd_size", "scale_factor", "noise_amp",
    "min_size", "max_size", "img_size", "sampling_rates", "stop_scale_time",
    "start_frame", "max_frames", "train_all", "bf16",
    "video_path", "image_path", "pconv_all", "wpack",
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
    """A loaded checkpoint with rand/rec/inject samplers on ``device``.

    ``cfg`` must already have the snapshot applied and ``adjust_scales()``
    called by the caller (the CLIs own flag parsing); the session owns the
    geometry, the model and the samplers.  ``device`` defaults to the card
    and raises when there is none.  Each sampler runs under
    ``torch.inference_mode`` itself (a per-thread mode), so the server's
    threads may call it.  ``mesh_shape``: sample over a mesh of ranks
    (see the module docstring); every rank makes the same calls.
    """

    def __init__(self, cfg: Config, *, batch_size: int = 2,
                 manual_seed: int = 0, h_factor: float = 1.0,
                 w_factor: float = 1.0, t_factor: float = 1.0,
                 mesh_shape: str = "", device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.mesh = self._join(parse_mesh_shape(mesh_shape)) \
            if mesh_shape else None
        if not cfg.video_path and not cfg.image_path:
            raise RuntimeError(
                "no source clip/image configured: pass --video-path/"
                "--image-path, or keep the training config.json snapshot "
                "next to the --netG checkpoint")
        self.ndim = 3 if cfg.video_path else 2

        if not os.path.isfile(cfg.netG):
            raise RuntimeError(f"=> no <G> checkpoint found at '{cfg.netG}'")
        self._dataset = None
        if self.ndim == 3:
            cfg.ar, cfg.org_fps = read_geometry(cfg.netG)
            cfg.fps_lcm = reduce(math.lcm, cfg.sampling_rates)
            pyramid = cfg.pyramid()
        else:
            self._dataset = SingleImageDataset(cfg)   # sets cfg.ar
            pyramid = self._dataset.pyramid
        self.train_pyramid = pyramid

        # weights are built and loaded on the CPU, then moved: the growth
        # replay's stage init draws from a CPU generator either way
        init_gen = torch.Generator().manual_seed(manual_seed)
        G = make_generator(cfg.generator, cfg, pyramid, ndim=self.ndim)
        G.init(init_gen)
        raw = restore_generator(cfg.netG, G, init_gen)
        self.scale = int(raw["scale"])
        cfg.scale_idx = self.scale
        # sampling geometry: possibly an extrapolated pyramid (the model
        # is fully convolutional)
        if (h_factor, w_factor, t_factor) != (1.0, 1.0, 1.0):
            pyramid = ScaledPyramid(pyramid, h_factor, w_factor, t_factor)
            G.pyramid = pyramid
        self.G = G.to(self.device)
        if self.mesh is not None:
            replicate(self.G, self.mesh)
        self.pyramid = pyramid
        self.amps = [float(a) for a in raw["noise_amps"]]
        self.generator = torch.Generator(device=self.device).manual_seed(
            manual_seed)

        # the HP-VAE-GAN family samples latent-dim noise through the
        # decoder, the baselines image-channel noise
        self.is_triple = G.returns_triple
        self.noise_shape = (self.batch_size,
                            *(pyramid.shape3d(0) if self.ndim == 3
                              else pyramid.shape2d(0)),
                            cfg.latent_dim if self.is_triple else cfg.nc_im)
        self._rec_input = self._z_init = None

    def _join(self, shape):
        """This rank's mesh of ``shape``: a mesh of several ranks joins
        the launch first (on the rank's card under CUDA); the session's
        batch must split over the data axis."""
        if math.prod(shape) > 1:
            maybe_initialize(True, device_type=self.device.type)
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        mesh = make_mesh(shape)
        mesh.batch_rows(self.batch_size)
        return mesh

    def _host(self, out: torch.Tensor) -> np.ndarray:
        """A sampler's output on the host as float32, whole: under a mesh
        gathered from every rank's block (every rank gets it)."""
        with span("serve.host"):
            out = out.float()
            if self.mesh is not None:
                out = self.mesh.gather_whole(out, 2 if self.ndim == 3 else 1)
            return out.cpu().numpy()

    # ---- the clip (rec and inject modes) ----

    @property
    def dataset(self):
        """The training clip at the training geometry, opened from its
        frames file on first use (3D), or the image (2D)."""
        if self._dataset is None:
            self._dataset = SingleVideoDataset(self.cfg, self.train_pyramid)
        return self._dataset

    def has_frames(self) -> bool:
        """Is the real sample there (rec and inject need it)?  A 2D
        session has read its image already."""
        return (self.ndim == 2
                or os.path.isfile(frames_path(self.cfg.video_path)))

    def _real(self, scale: int):
        """(current, zero-scale or None) real sample at ``scale``: the
        first window of the clip, or the image, unflipped."""
        if self.ndim == 2:
            return self.dataset.get(0, scale, hflip=False)
        self.dataset.generate_frames(scale)
        return self.dataset.get(0, hflip=False, scale_idx=scale)

    def real_clip(self, scale: int) -> np.ndarray:
        """The real clip (T, H, W, 3), or image (H, W, 3), at pyramid
        level ``scale``."""
        return self._real(scale)[0]

    def rec_input(self):
        """``(real_zero batch, real current-scale clip)``: the rec-mode
        conditioning input, the real sample's zero-scale clip repeated to
        the batch, or, for the baselines, the ``Z_init`` checkpointed beside
        ``netG`` (raises naming it when it is missing).  Cached after first
        use (JAX ``serving.py:226-248``)."""
        if self._rec_input is None:
            cur, zero = self._real(self.scale)
            if zero is None:
                zero = cur
            self._rec_input = (np.stack([zero] * self.batch_size)
                               if self.is_triple else self.z_init(), cur)
        return self._rec_input

    def z_init(self) -> np.ndarray:
        """The baselines' fixed reconstruction noise, read once from the
        ``Z_init`` file beside ``netG`` (either package's); raises naming
        the path when it is missing (JAX ``serving.py:240-244``)."""
        if self._z_init is None:
            z_path = os.path.join(os.path.dirname(self.cfg.netG), "Z_init")
            if not os.path.exists(z_path):
                raise RuntimeError(f"baselines rec mode needs {z_path}")
            self._z_init = np.asarray(restore_file(z_path)["data"],
                                      np.float32)
        return self._z_init

    # ---- convenience entry points (one batch each) ----

    def _generator(self, generator: Optional[torch.Generator]
                   ) -> torch.Generator:
        return self.generator if generator is None else generator

    def _apply(self, **kw) -> torch.Tensor:
        """The generator's sample alone, whatever its family returns."""
        with span("serve.forward"):
            out = self.G.apply(self.amps, train=True, **kw)
            return out[0] if self.is_triple else out

    @staticmethod
    def _latent_kw(latents) -> dict:
        """``GeneratorVAE_nb``'s explicit rand latents as ``apply``
        arguments (none: drawn from the batch's generator)."""
        if latents is None:
            return {}
        return {"noise_init_norm": latents[0], "noise_init_bern": latents[1]}

    def sample_batch(self, generator: Optional[torch.Generator] = None, *,
                     noise=None, noises: Optional[Sequence] = None,
                     latents=None) -> np.ndarray:
        """One rand-mode batch, NTHWC in [-1, 1], float32 (holding bf16
        values under ``bf16``): draw the latent ``noise`` (unless given),
        run the pyramid (BatchNorm on batch statistics, as in training).
        ``latents``: ``GeneratorVAE_nb``'s ``(z_norm, z_bern)``."""
        g = self._generator(generator)
        with span("serve.request"), torch.inference_mode():
            if noise is None:
                noise = torch.randn(self.noise_shape, generator=g,
                                    device=self.device)
            out = self._apply(noise_init=noise, mode="rand", noises=noises,
                              generator=g, **self._latent_kw(latents))
            return self._host(out)

    def reconstruct_batch(self, real_zero: Optional[np.ndarray] = None,
                          generator: Optional[torch.Generator] = None, *,
                          eps=None) -> np.ndarray:
        """One rec-mode batch from the real zero-scale clip ``real_zero``
        ((T,H,W,3) for one clip, or (H,W,3) for one image, repeated to
        the batch, or a batch); by default the clip's own
        (``rec_input``).  For the baselines ``real_zero`` is their fixed
        noise, by default the checkpointed ``Z_init`` (its batch is the
        training batch), and the forward draws nothing."""
        with span("serve.request"):
            if real_zero is None:
                real_zero = (self.rec_input()[0] if self.is_triple
                             else self.z_init())
            real_zero = np.asarray(real_zero, np.float32)
            if real_zero.ndim == self.ndim + 1:
                real_zero = np.stack([real_zero] * self.batch_size)
            g = self._generator(generator)
            with torch.inference_mode():
                if not self.is_triple:
                    out = self._apply(noise_init=real_zero, mode="rec")
                else:
                    out = self._apply(real_zero=real_zero, mode="rec",
                                      eps=eps, generator=g)
                return self._host(out)

    def inject_batch(self, x_init: np.ndarray, start: int,
                     generator: Optional[torch.Generator] = None, *,
                     noises: Optional[Sequence] = None,
                     latents=None) -> np.ndarray:
        """Refine the clips ``x_init`` (a batch at pyramid level
        ``start``) from stage ``start`` upward in rand mode, the decoder
        fed zeros (JAX ``inject_fn``, ``serving.py:203-210``); the
        baselines have no such mode and raise."""
        if not self.is_triple:
            raise ValueError("--inject-scale requires GeneratorHPVAEGAN")
        x_init = np.asarray(x_init, np.float32)
        g = self._generator(generator)
        with span("serve.request"), torch.inference_mode():
            zeros = torch.zeros((x_init.shape[0], *self.noise_shape[1:]),
                                device=self.device)
            out = self._apply(noise_init=zeros, sample_init=(start, x_init),
                              mode="rand", noises=noises, generator=g,
                              **self._latent_kw(latents))
            return self._host(out)

    def write_sample(self, frame: np.ndarray, path_base: str) -> str:
        """A [-1, 1] clip (T, H, W, 3) -> ``path_base + ".avi"``,
        uncompressed at the top scale's frame rate, or an image (H, W, 3)
        -> ``path_base + ".png"``, clipped to [-1, 1] first.  Returns the
        path."""
        if self.ndim == 2:
            path = path_base + ".png"
            write_png(np.clip(frame, -1, 1), path)
            return path
        path = path_base + ".avi"
        write_avi(frame, path, self.pyramid.fps(self.scale))
        return path

    def warmup(self, modes=("rand",)) -> None:
        """Run one batch per mode before serving (kernel build, allocator,
        cuDNN set-up).  ``rec`` runs on the clip when its frames file is
        there, else on zeros.  Unknown mode strings raise."""
        for mode in modes:
            g = torch.Generator(device=self.device).manual_seed(999983)
            if mode == "rand":
                self.sample_batch(g)
            elif mode == "rec":
                if self.has_frames() or not self.is_triple:
                    self.reconstruct_batch(None, g)
                else:
                    t0, h0, w0 = self.train_pyramid.shape3d(0)
                    self.reconstruct_batch(
                        np.zeros((t0, h0, w0, self.cfg.nc_im), np.float32),
                        g)
            else:
                raise ValueError(f"unknown warmup mode {mode!r} (rand|rec)")
