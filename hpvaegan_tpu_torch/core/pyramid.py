"""Spatio-temporal pyramid geometry — pure math, no JAX/torch deps.

A copy of ``hpvaegan_tpu/core/pyramid.py``: the port imports nothing of
the JAX package, so it keeps its own.  Both must give the same tables
(tests/test_torch_port_models.py holds them together).

Re-derivation of the reference's scale/fps scheduling contract
(reference utils/images.py:29-36,60-105).  Every function here is pure
and cheap; the whole pyramid is precomputed once per run and treated as
STATIC shape information by the jitted compute path (per-scale jit caches are
intentional — shapes legitimately change per scale).

Verified default schedule (img_size=256, min=32, max=256, sf_init=0.75,
sampling_rates=[4,3,2,1]):
  spatial sizes: 33,41,51,65,81,102,129,162,204,256  (10 scales, idx 0..9)
  time depths:   4,4,4,5,5,5,7,7,7,13
"""
from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "ScaleAdjustment",
    "adjust_scales",
    "get_scale_size",
    "get_fps_index",
    "get_fps",
    "get_time_depth",
    "Pyramid",
    "ScaledPyramid",
]


@dataclasses.dataclass(frozen=True)
class ScaleAdjustment:
    """Result of the pyramid fitting computation.

    Mirrors the fields the reference mutates onto ``opt``
    (utils/images.py:29-36): num_scales, stop_scale, scale1 and the
    *effective* scale factor recomputed so that exactly ``stop_scale`` steps
    span [min_size, img_size].
    """

    num_scales: int
    stop_scale: int
    scale1: float
    scale_factor: float  # effective factor, not the init one


def adjust_scales(size: int, min_size: int, max_size: int,
                  scale_factor_init: float) -> ScaleAdjustment:
    """Fit the scale pyramid to an image size (utils/images.py:29-36)."""
    num_scales = math.ceil(math.log(min_size / size, scale_factor_init)) + 1
    scale2stop = math.ceil(math.log(min(max_size, size) / size, scale_factor_init))
    stop_scale = num_scales - scale2stop
    scale1 = min(max_size / size, 1.0)
    scale_factor = math.pow(min_size / size, 1.0 / stop_scale)
    return ScaleAdjustment(
        num_scales=num_scales,
        stop_scale=stop_scale,
        scale1=scale1,
        scale_factor=scale_factor,
    )


def get_scale_size(index: int, scale_factor: float, stop_scale: int,
                   img_size: int) -> int:
    """Base (width) size of pyramid level ``index`` (utils/images.py:60-64)."""
    scale = math.pow(scale_factor, stop_scale - index)
    return math.ceil(scale * img_size)


def get_fps_index(index: int, stop_scale_time: int,
                  num_rates: int) -> int:
    """Linear fps interpolation by divisors (utils/images.py:67-71).

    Note the reference uses ``int()`` truncation, not round — preserved.
    """
    return int((index / stop_scale_time) * (num_rates - 1))


def get_fps(index: int, org_fps: float, sampling_rates: Sequence[int],
            stop_scale_time: int) -> Tuple[float, int]:
    fps_index = get_fps_index(index, stop_scale_time, len(sampling_rates))
    return org_fps / sampling_rates[fps_index], fps_index


def get_time_depth(index: int, fps_lcm: int, sampling_rates: Sequence[int],
                   stop_scale_time: int) -> int:
    """Frames per clip at level ``index`` (utils/images.py:74-80)."""
    fps_index = get_fps_index(index, stop_scale_time, len(sampling_rates))
    every = sampling_rates[fps_index]
    return fps_lcm // every + 1


def _lcm_reduce(values: Sequence[int]) -> int:
    return reduce(math.lcm, values)


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """Immutable pyramid geometry for one training run.

    All per-scale shapes are derived here once; the training loop treats them
    as static Python ints so every scale gets its own XLA-compiled step with
    fully static shapes (no dynamic-shape fallbacks on TPU).
    """

    img_size: int
    ar: float                      # aspect ratio H/W
    stop_scale: int
    scale_factor: float            # effective factor
    num_scales: int
    scale1: float
    # temporal schedule (video only; None fields unused for images)
    sampling_rates: Tuple[int, ...] = (4, 3, 2, 1)
    stop_scale_time: int = -1
    org_fps: float = 30.0

    @classmethod
    def for_image(cls, img_size: int, ar: float, min_size: int, max_size: int,
                  scale_factor_init: float) -> "Pyramid":
        adj = adjust_scales(img_size, min_size, max_size, scale_factor_init)
        return cls(img_size=img_size, ar=ar, stop_scale=adj.stop_scale,
                   scale_factor=adj.scale_factor, num_scales=adj.num_scales,
                   scale1=adj.scale1)

    @classmethod
    def for_video(cls, img_size: int, ar: float, min_size: int, max_size: int,
                  scale_factor_init: float, sampling_rates: Sequence[int],
                  org_fps: float, stop_scale_time: int = -1) -> "Pyramid":
        adj = adjust_scales(img_size, min_size, max_size, scale_factor_init)
        if stop_scale_time == -1:
            stop_scale_time = adj.stop_scale
        return cls(img_size=img_size, ar=ar, stop_scale=adj.stop_scale,
                   scale_factor=adj.scale_factor, num_scales=adj.num_scales,
                   scale1=adj.scale1, sampling_rates=tuple(sampling_rates),
                   stop_scale_time=stop_scale_time, org_fps=org_fps)

    # ---- temporal ----
    @property
    def fps_lcm(self) -> int:
        return _lcm_reduce(self.sampling_rates)

    def fps_index(self, index: int) -> int:
        return get_fps_index(index, self.stop_scale_time, len(self.sampling_rates))

    def fps(self, index: int) -> float:
        return self.org_fps / self.sampling_rates[self.fps_index(index)]

    def td(self, index: int) -> int:
        return get_time_depth(index, self.fps_lcm, self.sampling_rates,
                              self.stop_scale_time)

    # ---- spatial ----
    def base_size(self, index: int) -> int:
        return get_scale_size(index, self.scale_factor, self.stop_scale,
                              self.img_size)

    def spatial_size(self, index: int) -> Tuple[int, int]:
        """(H, W) at level ``index`` — H = int(base * ar) exactly as the
        reference truncates (datasets/video.py:86-87)."""
        base = self.base_size(index)
        return int(base * self.ar), base

    def shape2d(self, index: int) -> Tuple[int, int]:
        return self.spatial_size(index)

    def shape3d(self, index: int) -> Tuple[int, int, int]:
        """(T, H, W) at level ``index`` (utils/images.py:83-93)."""
        h, w = self.spatial_size(index)
        return self.td(index), h, w

    def all_shapes3d(self) -> List[Tuple[int, int, int]]:
        return [self.shape3d(i) for i in range(self.stop_scale + 1)]

    def all_shapes2d(self) -> List[Tuple[int, int]]:
        return [self.shape2d(i) for i in range(self.stop_scale + 1)]


@dataclasses.dataclass(frozen=True)
class ScaledPyramid:
    """Pyramid whose per-level shapes are scaled by constant factors.

    Enables spatial/temporal EXTRAPOLATION at generation time: the models
    are fully convolutional, so feeding scale-0 noise of k-times the size
    and upscaling through k-times-larger pyramid targets produces k-times-
    larger samples.  (The upstream hp-vae-gan paper's extrapolation
    application; this fork exposes no script for it — SURVEY §5.8.)
    """

    base: Pyramid
    h_factor: float = 1.0
    w_factor: float = 1.0
    t_factor: float = 1.0

    def __getattr__(self, name):
        return getattr(self.base, name)

    def td(self, index: int) -> int:
        return max(1, int(round(self.base.td(index) * self.t_factor)))

    def spatial_size(self, index: int) -> Tuple[int, int]:
        h, w = self.base.spatial_size(index)
        return max(1, int(round(h * self.h_factor))), \
            max(1, int(round(w * self.w_factor)))

    def shape2d(self, index: int) -> Tuple[int, int]:
        return self.spatial_size(index)

    def shape3d(self, index: int) -> Tuple[int, int, int]:
        h, w = self.spatial_size(index)
        return self.td(index), h, w
