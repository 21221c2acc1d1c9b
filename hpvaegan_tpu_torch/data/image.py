"""Image datasets (port of ``hpvaegan_tpu/data/image.py``; reference
datasets/image.py).

The JAX datasets decode with imageio and resize with OpenCV.  The machine
with the card has neither, so the port reads PNG itself
(``utils/png.py``), any other format from the frames file that ``python
-m hpvaegan_tpu_torch.tools.decode_frames <image>`` wrote beside it, and
resizes with ``data/video.py``'s ``resize_linear``, which is
``cv2.resize(..., INTER_LINEAR)`` bit for bit: the per-scale arrays
equal the JAX datasets'.

Semantics kept (datasets/image.py:13-120): for ``scale_idx > 0`` an item
is the (current-scale, zero-scale) pair with one shared hflip; ``len`` is
``data_rep`` times the number of images; ``cfg.ar`` is the H/W ratio of
the (first) image; a directory is read in ``os.listdir`` order (frames
files beside their images are skipped).
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..tools.decode_frames import frames_path
from ..utils.png import is_png, read_png
from .video import resize_linear

__all__ = ["read_image", "SingleImageDataset", "MultipleImageDataset"]

_FRAMES_SUFFIX = ".frames.npz"


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of the image at ``path``: a PNG read directly
    (alpha dropped), any other format from its frames file."""
    if is_png(path):
        img = read_png(path)
    else:
        fpath = frames_path(path)
        if not os.path.isfile(fpath):
            raise FileNotFoundError(
                f"{fpath} not found: the port reads PNG itself; decode "
                f"{path} once with `python -m "
                f"hpvaegan_tpu_torch.tools.decode_frames {path}` (needs "
                f"OpenCV)")
        with np.load(fpath) as data:
            img = np.asarray(data["frames"], np.uint8)[0]
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"{path}: an image of shape {img.shape}; the "
                         f"datasets take RGB or RGBA")
    return np.ascontiguousarray(img[:, :, :3])


def _to_unit_range(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (kornia normalize(0.5, 0.5))."""
    return img_u8.astype(np.float32) / 255.0 * 2.0 - 1.0


class _ImageDatasetBase:
    """Per-scale resize cache and pair semantics; subclasses set
    ``self.images``, the full-scale RGB uint8 images."""

    images: List[np.ndarray]

    def __init__(self, cfg, pyramid):
        self.cfg = cfg
        self.pyramid = pyramid
        self._cache: dict = {}  # scale_idx -> (num_images, H, W, 3) f32

    def _scaled(self, scale_idx: int) -> np.ndarray:
        if scale_idx not in self._cache:
            h, w = self.pyramid.shape2d(scale_idx)
            self._cache[scale_idx] = np.stack(
                [_to_unit_range(resize_linear(img[None], h, w)[0])
                 for img in self.images])
        return self._cache[scale_idx]

    def __len__(self) -> int:
        return self.cfg.data_rep * len(self.images)

    @property
    def n_starts(self) -> int:
        """Distinct items: the loader's cache stream takes indices modulo
        this (``device_cache_views``' ``n_start``)."""
        return len(self.images)

    def device_cache_views(self, scale_idx: int):
        """``(cur_store, zero_store, n_start, gather_kwargs)`` for
        ``data/device_cache.DeviceCacheLoader`` (JAX ``data/image.py:65``):
        the scale's images and the zero scale's (scale 0: its own)."""
        cur = self._scaled(scale_idx)
        zero = self._scaled(0) if scale_idx > 0 else cur
        return cur, zero, len(self.images), dict(
            hflip=bool(self.cfg.hflip), virtual_len=len(self))

    # the views change no state here (each scale's images are resized
    # once into their own cache entry): --compile-ahead's stores too
    device_cache_spec = device_cache_views

    def get(self, idx: int, scale_idx: int, hflip: bool
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(H, W, 3) image ``idx`` at ``scale_idx``, and its zero-scale
        pair above scale 0."""
        img_idx = idx % len(self.images)
        cur = self._scaled(scale_idx)[img_idx]
        if hflip:
            cur = cur[:, ::-1]
        if scale_idx > 0:
            zero = self._scaled(0)[img_idx]
            if hflip:
                zero = zero[:, ::-1]
            return cur, zero
        return cur, None

    def pairs(self, indices: Sequence[int], flips: Sequence[bool],
              scale_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (real, real_zero) for explicit indices and flips; at
        scale 0 the pair is the current image twice."""
        cur_list, zero_list = [], []
        for idx, flip in zip(indices, flips):
            cur, zero = self.get(int(idx), scale_idx, bool(flip))
            cur_list.append(cur)
            zero_list.append(cur if zero is None else zero)
        return np.ascontiguousarray(np.stack(cur_list)), \
            np.ascontiguousarray(np.stack(zero_list))

    def batch(self, rng: np.random.Generator, indices: np.ndarray,
              scale_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """One batch, each item with its own hflip draw from ``rng``
        under ``--hflip`` (datasets/image.py:51)."""
        flips = [bool(rng.random() < 0.5) if self.cfg.hflip else False
                 for _ in indices]
        return self.pairs(indices, flips, scale_idx)


class SingleImageDataset(_ImageDatasetBase):
    """One image, ``len`` = ``data_rep`` (datasets/image.py:72-91)."""

    def __init__(self, cfg, pyramid=None):
        if not os.path.exists(cfg.image_path):
            logging.error("invalid path")
            raise FileNotFoundError(cfg.image_path)
        img = read_image(cfg.image_path)
        self.images = [img]
        h, w = img.shape[:2]
        cfg.ar = h / w  # H2W aspect ratio (datasets/image.py:85)
        super().__init__(cfg, pyramid if pyramid is not None
                         else cfg.pyramid2d())


class MultipleImageDataset(_ImageDatasetBase):
    """Every image of a directory, of one size (datasets/image.py:94-120)."""

    def __init__(self, cfg, pyramid=None):
        if not (os.path.exists(cfg.image_path)
                and os.path.isdir(cfg.image_path)):
            logging.error("invalid path")
            raise FileNotFoundError(cfg.image_path)
        self.images = [read_image(os.path.join(cfg.image_path, name))
                       for name in os.listdir(cfg.image_path)
                       if not name.endswith(_FRAMES_SUFFIX)]
        assert len(self.images) > 0
        h, w = self.images[0].shape[:2]
        cfg.ar = h / w
        super().__init__(cfg, pyramid if pyramid is not None
                         else cfg.pyramid2d())
