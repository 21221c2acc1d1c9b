"""align_corners=True linear resize (port of ``hpvaegan_tpu/ops/resize.py``).

The reference resizes with ``F.interpolate(mode='bilinear'/'trilinear',
align_corners=True)`` (utils/images.py:9-26); the JAX package re-expresses
that as interpolation-matrix products.  Here the stock PyTorch op does it,
as XLA did without a hand kernel.

Layout: the port's model layout, NCHW (2D) and NCDHW (3D) tensors, kept in
whatever memory format they arrive in.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["interpolate_2d", "interpolate_3d", "upscale_2d", "upscale_3d"]


def interpolate_2d(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW tensors; 5-D NCDHW input is resized per
    frame (utils/images.py:9-19).  On 5-D input a trilinear resize that
    keeps T is exactly per-frame bilinear: with align_corners=True an
    unchanged axis maps every index onto itself."""
    if x.dim() == 4:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=True)
    if x.dim() == 5:
        return F.interpolate(x, size=(x.shape[2], *size), mode="trilinear",
                             align_corners=True)
    raise ValueError(f"expected 4D/5D, got {x.dim()}D")


def interpolate_3d(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of NCDHW tensors (utils/images.py:22-26)."""
    if x.dim() != 5:
        raise ValueError("input must be 5D (B, C, T, H, W)")
    return F.interpolate(x, size=tuple(size), mode="trilinear",
                         align_corners=True)


def upscale_2d(image: torch.Tensor, index: int, pyramid) -> torch.Tensor:
    """Resize an image to pyramid level ``index`` (utils/images.py:96-105)."""
    assert index > 0
    return interpolate_2d(image, pyramid.shape2d(index))


def upscale_3d(video: torch.Tensor, index: int, pyramid) -> torch.Tensor:
    """Joint space-time resize to level ``index`` (utils/images.py:83-93)."""
    assert index > 0
    return interpolate_3d(video, pyramid.shape3d(index))
