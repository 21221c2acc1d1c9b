"""Experiment tree and checkpoints (port of ``hpvaegan_tpu/utils/saver.py``;
reference utils/saver.py).

The layout is the JAX package's: ``run/<clip>/<checkname>/experiment_<N>/``
with an ``eval/`` subdirectory and auto-incremented run ids
(``saver.py:113-140``), and the same files and fields:

  netG          {scale, gvars, noise_amps, opt_g}: the growing generator
                (train_video.py:247-252)
  netD_<s>      {scale, dvars, opt_d}: the scale's critic, also the warm
                start of the next scale's (train_video.py:50-52, 253-258)
  Noise_Amps    {data}: the per-scale noise amplitudes, and
                Noise_Amps.json {noise_amps, scale}
  netG_mid      {scale, iteration, gvars, opt_g, dvars, opt_d, noise_amps}:
                the ``--save-interval`` checkpoint inside a scale
  config.json   the resolved configuration (``Config.snapshot_dict``)

The payloads are ``torch.save`` files: ``gvars``/``dvars`` are the
modules' ``state_dict``s, ``opt_g``/``opt_d`` the optimizers'.  Writes are
atomic (``.tmp`` then ``os.replace``) and run on a one-thread pool, after
the state was copied to the host, so training goes on while the file is
written; ``wait`` joins the pending write.

The readers also take the JAX package's flax-msgpack files
(``msgpack_reader``), told apart by their first byte: a JAX-trained
``netG`` and its ``netD_<s>``/``Noise_Amps`` can be sampled from and
trained on by the port.  A JAX ``netG_mid`` cannot (its optimizer states
are optax's) and raises.

``restore_generator`` and ``apply_resume`` replay stage growth before
loading, as ``hpvaegan_tpu/serving.py:154-160`` and ``saver.py:50-89`` do.

``VideoSaver`` and ``ImageSaver`` name the tree after the clip or the
image (``saver.py:211-230``); ``ImageSaver.save_image`` writes a PNG
(``write_png``, ``utils/png.py``) where the JAX saver calls
``cv2.imwrite``.

Under several ranks (``--distributed``) only rank 0 touches the
experiment tree, as in the JAX package (``saver.py:113-140``): the run id
is rank 0's (``multihost.agree``), the other ranks keep the paths and
every write of theirs is a no-op.
"""
from __future__ import annotations

import errno
import glob
import json
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel import multihost
from . import convert
from .msgpack_reader import is_msgpack_file, read_file
from .png import encode_png

__all__ = ["save_generator", "restore_file", "restore_generator",
           "load_critic", "apply_resume", "Saver", "VideoSaver",
           "ImageSaver", "write_png"]


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and copied to the
    host, so that a write in the background sees the state of now, not
    that of a later in-place update."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(payload: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)   # a reader never sees a partial file


def save_generator(path: str, G, scale: int,
                   noise_amps: Sequence[float]) -> None:
    """Write ``G`` alone as a ``netG`` file (no optimizer state)."""
    _write({"scale": int(scale),
            "noise_amps": [float(a) for a in noise_amps],
            "gvars": _to_host(G.state_dict())}, path)


def restore_file(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint, the port's (tensors on the CPU) or the
    JAX package's (numpy arrays)."""
    if not os.path.isfile(path):
        raise RuntimeError(f"=> no <G> checkpoint found at '{path}'")
    if is_msgpack_file(path):
        return read_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_generator(path: str, G,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
    """Grow ``G`` (fresh encoder/decoder, empty body) to the checkpointed
    scale, then load its weights, from either package's ``netG``.
    Returns the payload."""
    raw = restore_file(path)
    if is_msgpack_file(path):
        convert.load_generator(G, raw["gvars"])
        return raw
    for _ in range(int(raw["scale"])):
        G.init_next_stage(generator)
    G.load_state_dict(raw["gvars"])
    return raw


def load_critic(path: str, D) -> None:
    """Load a ``netD_<s>`` file of either package into the critic ``D``;
    a missing file raises FileNotFoundError naming it, as the JAX
    package's ``open`` does (``hpvaegan_tpu/utils/saver.py:172-174``)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(errno.ENOENT, "no critic checkpoint", path)
    raw = restore_file(path)
    if is_msgpack_file(path):
        convert.load_discriminator(D, raw["dvars"])
    else:
        D.load_state_dict(raw["dvars"])


def _amps(value) -> list:
    return [float(a) for a in np.asarray(value, np.float64).reshape(-1)]


def apply_resume(cfg, G, generator: Optional[torch.Generator] = None) -> None:
    """``--netG`` resume (``hpvaegan_tpu/utils/saver.py:50-89``): growth
    replay and the weights, then

    * for an end-of-scale ``netG``: the checkpointed scale is trained again
      from iteration 0, with the amps from the sibling ``Noise_Amps`` file
      (else the payload's own copy);
    * for a ``netG_mid``: the payload (iteration, both optimizer states,
      the critic) is kept on ``cfg`` for ``train_scale``, which resumes the
      scale at that iteration.
    """
    raw = restore_generator(cfg.netG, G, generator)
    cfg.scale_idx = cfg.resumed_idx = int(raw["scale"])
    cfg.resume_dir = os.path.dirname(cfg.netG)
    if "iteration" in raw:
        if is_msgpack_file(cfg.netG):
            raise NotImplementedError(
                "a JAX netG_mid carries optax optimizer states; resume the "
                "port from a JAX run's end-of-scale netG instead")
        cfg.resume_iteration = int(raw["iteration"])
        cfg._mid_raw = raw
        cfg.Noise_Amps = _amps(raw["noise_amps"])
        return
    amps_path = os.path.join(cfg.resume_dir, "Noise_Amps")
    cfg.Noise_Amps = _amps(restore_file(amps_path)["data"]
                           if os.path.exists(amps_path)
                           else raw["noise_amps"])


class Saver:
    """The experiment directory and its checkpoint files."""

    def __init__(self, cfg, clip_name: str, run_id: Optional[int] = None):
        self.cfg = cfg
        self.primary = multihost.is_primary()
        self.directory = os.path.join(cfg.run_dir, clip_name, cfg.checkname)
        if run_id is None:
            runs = sorted(glob.glob(os.path.join(self.directory,
                                                 "experiment_*")),
                          key=lambda p: int(p.rsplit("_", 1)[-1]))
            run_id = int(runs[-1].rsplit("_", 1)[-1]) + 1 if runs else 0
            # rank 0's id: its glob sees the tree it writes
            run_id = multihost.agree(run_id)
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id}")
        self.eval_dir = os.path.join(self.experiment_dir, "eval")
        if self.primary:
            os.makedirs(self.eval_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="saver")
        self._pending: Optional[Future] = None

    def save_checkpoint(self, state: Any, filename: str,
                        blocking: bool = False) -> None:
        """Copy ``state`` to the host now, write it in the background
        (rank 0 only)."""
        if not self.primary:
            return
        host_state = _to_host(state)
        self.wait()
        self._pending = self._pool.submit(
            _write, host_state, os.path.join(self.experiment_dir, filename))
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the pending write; raises what the write raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def load_checkpoint(self, filename: str,
                        directory: Optional[str] = None) -> Any:
        return restore_file(os.path.join(directory or self.experiment_dir,
                                         filename))

    def save_json(self, obj: Any, filename: str) -> None:
        if not self.primary:
            return
        with open(os.path.join(self.experiment_dir, filename), "w") as f:
            json.dump(obj, f)


class VideoSaver(Saver):
    def __init__(self, cfg, run_id: Optional[int] = None):
        clip_name = ".".join(os.path.basename(cfg.video_path).split(".")[:-1])
        super().__init__(cfg, clip_name, run_id)


def write_png(array: np.ndarray, path: str) -> None:
    """A [-1, 1] RGB image (H, W, 3) -> ``path`` as an RGB PNG of
    ``uint8((x + 1) * 127.5)``, the truncating cast of the JAX package's
    ``cv2.imwrite`` (``hpvaegan_tpu/utils/saver.py:225-230``, whose
    RGB -> BGR swap cv2 undoes on writing)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes images as PNG only")
    img = np.uint8((np.asarray(array, np.float32) + 1.0) * 127.5)
    with open(path, "wb") as f:
        f.write(encode_png(img))


class ImageSaver(Saver):
    """The experiment tree of an image run: the clip name is the image's
    (or the directory's) name up to its last dot."""

    def __init__(self, cfg, run_id: Optional[int] = None):
        clip_name = ".".join(os.path.basename(cfg.image_path).split(".")[:-1])
        super().__init__(cfg, clip_name, run_id)

    def save_image(self, array: np.ndarray, filename: str) -> None:
        if not self.primary:
            return
        write_png(array, os.path.join(self.eval_dir, filename))
