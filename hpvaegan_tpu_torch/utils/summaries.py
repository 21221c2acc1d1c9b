"""TensorBoard summaries (port of ``hpvaegan_tpu/utils/summaries.py:17-80``;
reference utils/summaries.py).

The same tags (``Video/Scale {s}/{name}`` with an ``_unfold`` frame grid,
``Image/Scale {s}/{name}``), the same ``_make_grid`` and the same
neptune either-or routing as the JAX package, written through
``tb_events.EventFileWriter`` instead of tensorboardX, which the machine
with the card lacks.  Images become uint8 as tensorboardX's ``image()``
makes them (x 255, then a truncating cast), and a batch of clips is tiled
as its ``utils._prepare_video`` tiles it before the GIF is encoded.
Inputs are channels-last.  Under several ranks only rank 0 opens one (the
training CLI hands the others None, as the JAX CLI does).
"""
from __future__ import annotations

import numpy as np

from .tb_events import EventFileWriter

__all__ = ["TensorboardSummary", "prepare_video"]


def _make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2
               ) -> np.ndarray:
    """(N, H, W, C) float [-1,1] -> (H', W', C) float [0,1] grid."""
    images = (np.clip(images, -1, 1) + 1.0) / 2.0
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def _to_uint8(x: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8, as tensorboardX converts a float image."""
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def prepare_video(clips: np.ndarray) -> np.ndarray:
    """(B, T, H, W, C) -> (T, rows * H, cols * W, C): tensorboardX's
    ``utils._prepare_video`` on channels-last clips (the batch padded with
    black clips to a power of 2, ``2**((B.bit_length() - 1) // 2)``
    rows)."""
    b, t, h, w, c = clips.shape
    if b & (b - 1):
        extra = 2 ** b.bit_length() - b
        clips = np.concatenate([clips, np.zeros((extra, t, h, w, c))])
    n_rows = 2 ** ((b.bit_length() - 1) // 2)
    n_cols = clips.shape[0] // n_rows
    v = clips.reshape(n_rows, n_cols, t, h, w, c).transpose(2, 0, 3, 1, 4, 5)
    return v.reshape(t, n_rows * h, n_cols * w, c)


class TensorboardSummary:
    """Event-file writer with an optional neptune experiment route.

    When a neptune experiment is passed, scalars and image grids go to
    neptune INSTEAD of TensorBoard, mirroring the reference's either/or
    routing (utils/summaries.py:26-30, 46-52).
    """

    def __init__(self, directory: str, neptune_exp=None):
        self.writer = EventFileWriter(directory)
        self.neptune_exp = neptune_exp

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self.neptune_exp is not None:
            self.neptune_exp.log_metric(tag, step, float(value))
        else:
            self.writer.add_scalar(tag, float(value), step)

    def visualize_video(self, cfg, iteration: int, videos, name: str) -> None:
        """(B, T, H, W, C) in [-1,1]: unfolded frame grid + first-3 clips,
        tagged ``Video/Scale {s}/{name}[_unfold]`` (utils/summaries.py:32-44)."""
        vids = np.asarray(videos)
        b, t, h, w, c = vids.shape
        scale = getattr(cfg, "scale_idx", 0)
        frames = vids.reshape(b * t, h, w, c)
        grid = _make_grid(frames, nrow=t)
        self.writer.add_image(f"Video/Scale {scale}/{name}_unfold",
                              _to_uint8(grid), iteration)
        clips = np.clip((vids[:3] + 1.0) / 2.0, 0, 1)
        self.writer.add_gif(f"Video/Scale {scale}/{name}",
                            _to_uint8(prepare_video(clips)), iteration,
                            fps=int(max(1, getattr(cfg, "fps", 4))))

    def visualize_image(self, cfg, iteration: int, images, name: str) -> None:
        """3-image grid tagged ``Image/Scale {s}/{name}``
        (utils/summaries.py:46-52)."""
        imgs = np.asarray(images)[:3]
        grid = _make_grid(imgs, nrow=3)
        tag = f"Image/Scale {getattr(cfg, 'scale_idx', 0)}/{name}"
        if self.neptune_exp is not None:
            self.neptune_exp.log_image(tag, iteration,
                                       y=(grid * 255).astype(np.uint8))
        else:
            self.writer.add_image(tag, _to_uint8(grid), iteration)

    def close(self) -> None:
        self.writer.close()
