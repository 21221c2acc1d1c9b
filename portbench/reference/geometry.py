"""The spatio-temporal pyramid of HP-VAE-GAN (lior1990/hp-vae-gan
utils/images.py:29-105), frozen here for the benchmark's reference.

Pure integer and float arithmetic: the sizes of every level, the frame
rate index and the number of frames a level's clip holds."""
from __future__ import annotations

import math
from functools import reduce
from typing import Sequence, Tuple

__all__ = ["Pyramid"]


class Pyramid:
    """The levels ``0 .. stop_scale`` of a run on an input of aspect ratio
    ``ar`` (H / W)."""

    def __init__(self, img_size: int, min_size: int, max_size: int,
                 scale_factor: float, ar: float,
                 sampling_rates: Sequence[int] = (4, 3, 2, 1)):
        num_scales = math.ceil(math.log(min_size / img_size,
                                        scale_factor)) + 1
        scale2stop = math.ceil(math.log(min(max_size, img_size) / img_size,
                                        scale_factor))
        self.stop_scale = num_scales - scale2stop
        self.scale_factor = math.pow(min_size / img_size,
                                     1.0 / self.stop_scale)
        self.img_size = img_size
        self.ar = ar
        self.rates = tuple(sampling_rates)
        self.fps_lcm = reduce(math.lcm, self.rates)

    def hw(self, index: int) -> Tuple[int, int]:
        """(H, W) of level ``index``: W rounded up, H = int(W * ar)."""
        w = math.ceil(math.pow(self.scale_factor, self.stop_scale - index)
                      * self.img_size)
        return int(w * self.ar), w

    def every(self, index: int) -> int:
        """The frame stride of level ``index`` (``int`` truncation, as the
        reference's ``get_fps_index``)."""
        k = int((index / self.stop_scale) * (len(self.rates) - 1))
        return self.rates[k]

    def td(self, index: int) -> int:
        return self.fps_lcm // self.every(index) + 1

    def thw(self, index: int) -> Tuple[int, int, int]:
        return (self.td(index), *self.hw(index))
