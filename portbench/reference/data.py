"""The training clip or image at a pyramid level, for the benchmark's
reference: frames read from the committed frames file, resized as OpenCV's
``cv2.resize(..., INTER_LINEAR)`` resizes uint8 frames (the reference
repository's datasets/video.py and datasets/image.py), scaled to [-1, 1].

The resize is a frozen copy of that arithmetic: half-pixel source
coordinates in float32, 11-bit integer coefficients, an integer
horizontal pass and OpenCV's vertical pass; an exact 2x downscale is
OpenCV's INTER_AREA average."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["read_frames", "resize_u8", "video_pair", "image_pair"]

_COEF_SCALE = 1 << 11


def read_frames(path: str) -> Tuple[np.ndarray, float]:
    """(frames (N, H, W, 3) uint8, fps) of a ``.frames.npz`` file."""
    with np.load(path) as data:
        return np.asarray(data["frames"], np.uint8), float(data["fps"])


def _taps(src: int, dst: int, clamp_weights: bool):
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_weights:
        f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    return i0, i1, a0, a1


def resize_u8(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """Every frame of (N, H, W, C) uint8 ``frames`` resized to (h, w)."""
    H, W = frames.shape[1:3]
    if (H, W) == (h, w):
        return frames.copy()
    x = frames.astype(np.int64)
    if (H, W) == (2 * h, 2 * w):
        s = (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2]
             + x[:, 1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _taps(W, w, clamp_weights=True)
    y0, y1, b0, b1 = _taps(H, h, clamp_weights=False)
    rows = x[:, :, x0] * a0[:, None] + x[:, :, x1] * a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = ((((rows[:, y0] >> 4) * b0) >> 16)
           + (((rows[:, y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _unit(frames: np.ndarray) -> np.ndarray:
    return frames.astype(np.float32) / 255.0 * 2.0 - 1.0


def video_pair(frames: np.ndarray, pyr, scale: int, batch: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(real, real_zero), NTHWC float32: the clip from frame 0 at level
    ``scale`` (every ``pyr.every(scale)``-th frame) and at level 0 (every
    ``pyr.rates[0]``-th), each repeated ``batch`` times.  The clip has one
    start frame (its length is ``fps_lcm + 1``) and is not flipped."""
    cur = _unit(resize_u8(frames, *pyr.hw(scale)))
    zero = _unit(resize_u8(frames, *pyr.hw(0)))
    clip = cur[0:pyr.fps_lcm + 1:pyr.every(scale)]
    clip0 = zero[0:pyr.fps_lcm + 1:pyr.rates[0]]
    return (np.stack([clip] * batch), np.stack([clip0] * batch))


def image_pair(image: np.ndarray, pyr, scale: int, batch: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(real, real_zero), NHWC float32: the image at level ``scale`` and at
    level 0, each repeated ``batch`` times."""
    cur = _unit(resize_u8(image[None], *pyr.hw(scale)))[0]
    zero = _unit(resize_u8(image[None], *pyr.hw(0)))[0]
    return np.stack([cur] * batch), np.stack([zero] * batch)
