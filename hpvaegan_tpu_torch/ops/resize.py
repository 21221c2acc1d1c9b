"""align_corners=True linear resize (port of ``hpvaegan_tpu/ops/resize.py``).

The reference resizes with ``F.interpolate(mode='bilinear'/'trilinear',
align_corners=True)`` (utils/images.py:9-26); the JAX package re-expresses
that as one dense (out, in) interpolation matrix per axis, contracted with
the tensor axis by axis, shrinking axes first.  The port does the same, so
that it rounds where the JAX package rounds: the matrix is built in the
input's dtype (bf16 weights under ``--bf16``, ``resize.py:64``), each
axis is contracted with f32 products and sums, and each axis's result is
rounded to the input's dtype.

Layout: the port's model layout, NCHW (2D) and NCDHW (3D) tensors; a
channels-last input gives a channels-last output.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["interp_matrix", "interpolate_2d", "interpolate_3d", "upscale_2d",
           "upscale_3d"]


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) align_corners=True linear interp matrix
    (a copy of ``hpvaegan_tpu/ops/resize.py:36-52``)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        # torch maps the single output to source coordinate 0
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def interp_matrix(in_size: int, out_size: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """The interpolation matrix with its weights rounded to ``dtype``
    (on a card: uploaded once, shared; read it, do not write it)."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return torch.from_numpy(_interp_matrix_np(in_size, out_size)).to(
            dtype=dtype)
    return _on_device(in_size, out_size, dtype, device)


# kept: a step replayed as a CUDA graph (train/graphs.py) may not copy
# from host memory, and its eager first run uploads every matrix it needs
@functools.lru_cache(maxsize=None)
def _on_device(in_size: int, out_size: int, dtype,
               device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode
    # (sampling), since training steps save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix_np(in_size, out_size)).to(
            device=device, dtype=dtype)


def _resize_axis(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    m = interp_matrix(in_size, out_size, x.dtype, x.device).float()
    out = torch.matmul(x.movedim(axis, -1).float(), m.T)
    return out.to(x.dtype).movedim(-1, axis)


def _resize_linear(x: torch.Tensor, sizes: Sequence[int],
                   axes: Sequence[int]) -> torch.Tensor:
    """Separable resize over ``axes``, shrinking axes first (the JAX
    package's order, ``resize.py:70-80``)."""
    fmt = (torch.channels_last_3d if x.dim() == 5 else torch.channels_last)
    channels_last = x.is_contiguous(memory_format=fmt)
    order = sorted(range(len(axes)), key=lambda i: sizes[i] / x.shape[axes[i]])
    for i in order:
        x = _resize_axis(x, sizes[i], axes[i])
    return x.contiguous(memory_format=fmt if channels_last
                        else torch.contiguous_format)


def interpolate_2d(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW tensors; 5-D NCDHW input is resized per
    frame (utils/images.py:9-19)."""
    if x.dim() == 4:
        return _resize_linear(x, size, axes=(2, 3))
    if x.dim() == 5:
        return _resize_linear(x, size, axes=(3, 4))
    raise ValueError(f"expected 4D/5D, got {x.dim()}D")


def interpolate_3d(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of NCDHW tensors (utils/images.py:22-26)."""
    if x.dim() != 5:
        raise ValueError("input must be 5D (B, C, T, H, W)")
    return _resize_linear(x, size, axes=(2, 3, 4))


def upscale_2d(image: torch.Tensor, index: int, pyramid) -> torch.Tensor:
    """Resize an image to pyramid level ``index`` (utils/images.py:96-105)."""
    assert index > 0
    return interpolate_2d(image, pyramid.shape2d(index))


def upscale_3d(video: torch.Tensor, index: int, pyramid) -> torch.Tensor:
    """Joint space-time resize to level ``index`` (utils/images.py:83-93)."""
    assert index > 0
    return interpolate_3d(video, pyramid.shape3d(index))
