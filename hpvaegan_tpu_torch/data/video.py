"""Single-video dataset (port of ``hpvaegan_tpu/data/video.py:59-220``;
reference datasets/video.py + generate_frames.py).

The JAX dataset decodes the clip with OpenCV at every scale.  The machine
with the card has no OpenCV, so the port never decodes video: it reads the
frames file that ``python -m hpvaegan_tpu_torch.tools.decode_frames <clip>``
wrote beside the clip once (every frame, RGB uint8, native size, and the
clip's fps), and resizes per scale in numpy.

``resize_linear`` reproduces ``cv2.resize(..., INTER_LINEAR)`` on uint8
bit for bit, downscale or upscale, so the per-scale frames equal the JAX
dataset's: half-pixel source coordinates in float32, coefficients rounded
to 11-bit integers, an integer horizontal pass, then OpenCV's vectorised
vertical pass
``((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2``.
OpenCV clamps the two axes differently at the edges: a column outside the
source takes the edge column with weights (1, 0), while a row outside it
keeps its fractional weights and reads the clamped edge row twice (which
an upscale's first and last rows do, rounding some pixels one level
lower).  An exact 2x downscale in both axes is OpenCV's INTER_AREA
average, as ``cv2.resize`` switches to it.

Pair semantics are kept (datasets/video.py:44-66): for ``scale_idx > 0``
each sample is (current-scale clip, zero-scale clip at
``sampling_rates[0]``) at the same start index with one shared hflip.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..tools.decode_frames import frames_path

__all__ = ["resize_linear", "read_frames", "SingleVideoDataset"]

_COEF_BITS = 11           # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """(i0, i1, a0, a1): source indices and 11-bit weights per output
    index, as OpenCV's resize computes them for INTER_LINEAR.  Indices
    are clamped to the source; with ``clamp_weights`` (OpenCV's columns,
    not its rows) an index outside it also gets the weights (1, 0)."""
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


def resize_linear(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)`` for
    every frame of (N, H, W, C) uint8 ``frames``."""
    H, W = frames.shape[1:3]
    if (H, W) == (h, w):
        return frames.copy()
    x = frames.astype(np.int64)
    if (H, W) == (2 * h, 2 * w):   # cv2 takes INTER_AREA here
        s = (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2]
             + x[:, 1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(W, w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(H, h, clamp_weights=False)
    rows = x[:, :, x0] * a0[:, None] + x[:, :, x1] * a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = ((((rows[:, y0] >> 4) * b0) >> 16)
           + (((rows[:, y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def read_frames(video_path: str) -> Tuple[np.ndarray, float]:
    """(frames (N,H,W,3) uint8, fps) from the frames file of
    ``video_path``; raises ``FileNotFoundError`` naming the tool when it is
    missing."""
    path = frames_path(video_path)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: decode the clip once with `python -m "
            f"hpvaegan_tpu_torch.tools.decode_frames {video_path}` (needs "
            f"OpenCV; the port reads the frames file, not the video)")
    with np.load(path) as data:
        return np.asarray(data["frames"], np.uint8), float(data["fps"])


class SingleVideoDataset:
    """Per-scale frame store from the clip's frames file
    (datasets/video.py:12-92)."""

    def __init__(self, cfg, pyramid=None):
        raw, cfg.org_fps = read_frames(cfg.video_path)
        h, w = raw.shape[1:3]
        self.org_frame_size = [float(h), float(w)]
        cfg.ar = float(h) / float(w)   # H2W (datasets/video.py:32)
        cfg.fps_lcm = int(np.lcm.reduce(np.asarray(cfg.sampling_rates)))
        # video_to_frames' start/max window (generate_frames.py:7-54)
        if not len(raw) > cfg.start_frame >= 0:
            raise ValueError(f"start frame {cfg.start_frame} out of range "
                             f"for {len(raw)} frames")
        self._raw = raw[cfg.start_frame:cfg.start_frame + cfg.max_frames]

        self.cfg = cfg
        self.pyramid = pyramid if pyramid is not None else cfg.pyramid()

        logging.info("Saving zero-level frames...")
        self.zero_scale_frames = self._generate_frames(0)  # float32 [-1,1]
        self.frames: Optional[np.ndarray] = None
        self._frames_scale: Optional[int] = None
        self._prefetch: Optional[tuple] = None  # (scale_idx, thread, box)

    def _generate_frames(self, scale_idx: int) -> np.ndarray:
        h, w = self.pyramid.shape2d(scale_idx)
        raw = resize_linear(self._raw, h, w)
        return raw.astype(np.float32) / 255.0 * 2.0 - 1.0  # (N, H, W, 3)

    def generate_frames(self, scale_idx: int) -> None:
        """This scale's frames, once per scale (train_video.py:36); a
        repeat call for the current scale does nothing, and a prefetched
        scale is taken from its thread."""
        if self._frames_scale == scale_idx and self.frames is not None:
            return
        pf = self._prefetch
        if pf is not None and pf[0] == scale_idx:
            _, thread, box = pf
            thread.join()
            self._prefetch = None
            if "frames" in box:
                self.frames = box["frames"]
                self._frames_scale = scale_idx
                return
            logging.warning(
                f"decode-ahead for scale {scale_idx} failed "
                f"({box.get('error')!r}); resizing synchronously")
        self.frames = self._generate_frames(scale_idx)
        self._frames_scale = scale_idx

    def prefetch_frames(self, scale_idx: int) -> None:
        """Resize ``scale_idx``'s frames in a daemon thread
        (``--decode-ahead``) while this scale trains; the next
        ``generate_frames(scale_idx)`` joins it, and an error there falls
        back to a synchronous resize."""
        if (self._frames_scale == scale_idx
                or (self._prefetch is not None
                    and self._prefetch[0] == scale_idx)):
            return
        box: dict = {}

        def _work() -> None:
            try:
                box["frames"] = self._generate_frames(scale_idx)
            except Exception as e:  # noqa: BLE001 - re-done synchronously
                box["error"] = e

        thread = threading.Thread(target=_work, daemon=True,
                                  name=f"decode-ahead-{scale_idx}")
        thread.start()
        self._prefetch = (scale_idx, thread, box)

    def __len__(self) -> int:
        return (len(self.zero_scale_frames) - self.cfg.fps_lcm) \
            * self.cfg.data_rep

    @property
    def n_starts(self) -> int:
        """Distinct start frames: the loader's cache stream takes indices
        modulo this (``device_cache_views``' ``n_start``)."""
        return len(self.zero_scale_frames) - self.cfg.fps_lcm

    def device_cache_views(self, scale_idx: int):
        """``(cur_store, zero_store, n_start, gather_kwargs)`` for
        ``data/device_cache.DeviceCacheLoader`` (JAX ``data/video.py:
        169-188``): the scale's frames and the zero scale's, or at scale
        0 its own frames twice, at the same stride.  They become the
        current frames (``generate_frames``)."""
        self.generate_frames(scale_idx)
        return self._views(scale_idx, self.frames)

    def device_cache_spec(self, scale_idx: int):
        """``device_cache_views(scale_idx)`` without touching the current
        frames (the counterpart of JAX ``device_cache_spec``, ``data/
        video.py:190``): ``--compile-ahead`` builds the next scale's
        stores while this one trains on its frames.  The next scale's
        frames are resized apart, the same values ``generate_frames``
        makes."""
        frames = (self.frames if self._frames_scale == scale_idx
                  else self._generate_frames(scale_idx))
        return self._views(scale_idx, frames)

    def _views(self, scale_idx: int, frames: np.ndarray):
        cfg = self.cfg
        every = cfg.sampling_rates[self.pyramid.fps_index(scale_idx)]
        if scale_idx > 0:
            zero, every0 = self.zero_scale_frames, cfg.sampling_rates[0]
        else:
            zero, every0 = frames, every
        kw = dict(td=cfg.fps_lcm // every + 1, every=every,
                  td0=cfg.fps_lcm // every0 + 1, every0=every0,
                  hflip=bool(cfg.hflip),
                  virtual_len=self.n_starts * cfg.data_rep)
        return frames, zero, self.n_starts, kw

    def get(self, idx: int, hflip: bool, scale_idx: Optional[int] = None
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One (T, H, W, C) clip; plus the zero-scale pair for
        ``scale_idx > 0``.  ``scale_idx`` selects the temporal stride
        (default: the config's current scale)."""
        cfg = self.cfg
        if scale_idx is None:
            scale_idx = cfg.scale_idx
            fps_index = cfg.fps_index
        else:
            fps_index = self.pyramid.fps_index(scale_idx)
        idx = idx % (len(self.zero_scale_frames) - cfg.fps_lcm)
        every = cfg.sampling_rates[fps_index]
        clip = self.frames[idx:idx + cfg.fps_lcm + 1:every]
        if hflip:
            clip = clip[:, :, ::-1]
        if scale_idx > 0:
            every0 = cfg.sampling_rates[0]
            zero = self.zero_scale_frames[idx:idx + cfg.fps_lcm + 1:every0]
            if hflip:
                zero = zero[:, :, ::-1]
            return clip, zero
        return clip, None

    def pairs(self, indices: Sequence[int], flips: Sequence[bool],
              scale_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (real, real_zero) for explicit start indices and flips;
        at scale 0 the pair is the current clip twice."""
        cur_list, zero_list = [], []
        for idx, flip in zip(indices, flips):
            cur, zero = self.get(int(idx), bool(flip), scale_idx)
            cur_list.append(cur)
            zero_list.append(cur if zero is None else zero)
        return np.ascontiguousarray(np.stack(cur_list)), \
            np.ascontiguousarray(np.stack(zero_list))

    def batch(self, rng: np.random.Generator, indices: np.ndarray,
              scale_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """The JAX dataset's ``batch``: one flip coin per sample from
        ``rng`` under ``--hflip``."""
        flips = [bool(rng.random() < 0.5) if self.cfg.hflip else False
                 for _ in indices]
        return self.pairs(indices, flips, scale_idx)
