"""SVFID — Single-Video Frechet Inception Distance on C3D features (port of
``hpvaegan_tpu/eval/_svfid.py``; HP-VAE-GAN, arXiv 2006.12226 §5).

For one real video and each generated one, every (t, h, w) site of a C3D
conv activation is one C-dimensional sample; SVFID is the Frechet
distance between the real video's feature statistics and the fake's,
averaged over the fakes.

The features run on ``device`` (the card unless the caller asks for the
CPU), in f32 with TF32 off; the mean and ``np.cov`` are taken in float64
on the host, as the JAX package takes them.  Weights: a Sports-1M C3D
state dict through ``weights_path`` (or ``$C3D_WEIGHTS``) for
paper-comparable numbers; without one, the fixed-seed random C3D that
the JAX package draws (``random_c3d_params``), so that a random score of
the port compares with the JAX package's, but not with published SVFID
values.  The built trunk is cached per (layer, seed, weights, device),
as the JAX package caches its jitted forward.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import full_f32, resolve_device
from ..utils import convert
from .c3d import (C3D, C3D_LAYERS, _PRE_POOL, load_c3d_torch, preprocess,
                  random_c3d_params)

__all__ = ["c3d_feature_stats", "frechet_distance", "svfid", "build_c3d"]

log = logging.getLogger(__name__)


def _tap_min_shape(feature_layer: str):
    """(min_T, min_HW) the pool schedule requires to reach the tap."""
    t, hw = 1, 1
    for name, _ in C3D_LAYERS:
        window = _PRE_POOL.get(name)
        if window is not None:
            t *= window[0]
            hw *= window[1]
        if name == feature_layer:
            return t, hw
    raise ValueError(f"unknown C3D layer {feature_layer!r}")


def build_c3d(params, feature_layer: str, device="cuda") -> C3D:
    """A ``C3D`` up to ``feature_layer`` holding ``params`` (a parameter
    tree, see ``c3d.py``) on ``device``, in eval mode."""
    model = C3D(feature_layer)
    convert.load_feature_convs(model, params)
    return model.to(resolve_device(device)).eval()


@functools.lru_cache(maxsize=None)
def _trunk(feature_layer: str, seed: int, weights_path: str,
           device: str) -> C3D:
    params = (load_c3d_torch(weights_path, feature_layer) if weights_path
              else random_c3d_params(feature_layer, seed))
    return build_c3d(params, feature_layer, device)


def _device_key(device) -> str:
    """The trunk caches' device key: ``"cuda"`` and ``"cuda:0"`` name one
    card when it is the current one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _positions(model: torch.nn.Module, x: torch.Tensor) -> np.ndarray:
    """The tap's (positions, C) features of channels-last ``x`` (N, ...,
    C), float64 on the host."""
    dev = next(model.parameters()).device
    with torch.inference_mode(), full_f32():
        x = x.to(dev)
        feats = model(x.movedim(-1, 1))
        flat = feats.movedim(1, -1).reshape(-1, feats.shape[1])
        return flat.double().cpu().numpy()


def _stats(flat: np.ndarray):
    return flat.mean(axis=0), np.cov(flat, rowvar=False)


def c3d_feature_stats(params, video_pm1: np.ndarray,
                      feature_layer: str = "conv3b", device="cuda"):
    """(mu, cov) over feature-map positions of one [-1,1] NTHWC video,
    (T, H, W, 3) or (1, T, H, W, 3).  ``params`` is a parameter tree
    (run on ``device``) or a built ``C3D`` (run where it lies)."""
    x = torch.as_tensor(np.asarray(video_pm1, np.float32))
    if x.dim() == 4:
        x = x[None]
    min_t, min_hw = _tap_min_shape(feature_layer)
    if x.shape[1] < min_t or x.shape[2] < min_hw or x.shape[3] < min_hw:
        raise ValueError(
            f"video {tuple(x.shape[1:4])} too small for C3D tap "
            f"{feature_layer!r} (needs T>={min_t}, H,W>={min_hw})")
    model = (params if isinstance(params, C3D)
             else build_c3d(params, feature_layer, device))
    return _stats(_positions(model, preprocess(x)))


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^(1/2)).

    sqrtm via scipy with an eps*I reseed when the product matrix is
    singular (ReLU feature covariances routinely are rank-deficient)."""
    import warnings

    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))

    diff = mu1 - mu2
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", linalg.LinAlgWarning)
            covmean = np.asarray(linalg.sqrtm(cov1 @ cov2))
        singular = not np.isfinite(covmean).all()
    except linalg.LinAlgWarning:
        singular = True
    if singular:
        offset = np.eye(cov1.shape[0]) * eps
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", linalg.LinAlgWarning)
            covmean = np.asarray(linalg.sqrtm((cov1 + offset)
                                              @ (cov2 + offset)))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def svfid(real_video: np.ndarray, fake_videos: Sequence[np.ndarray],
          weights_path: Optional[str] = None,
          feature_layer: str = "conv3b", seed: int = 0,
          device="cuda") -> dict:
    """SVFID of each fake against the single real video.

    Returns ``{"mean": float, "per_sample": [float, ...],
    "pretrained": bool, "feature_layer": str}``."""
    weights_path = weights_path or os.environ.get("C3D_WEIGHTS", "")
    if not weights_path:
        log.warning(
            "SVFID: no pretrained C3D weights (set $C3D_WEIGHTS or pass "
            "weights_path) — using a fixed-seed RANDOM C3D. Scores are "
            "deterministic and comparable to each other but NOT to "
            "published SVFID numbers.")
    model = _trunk(feature_layer, int(seed), weights_path,
                   _device_key(device))
    mu_r, cov_r = c3d_feature_stats(model, real_video, feature_layer)
    scores = []
    for fake in fake_videos:
        mu_f, cov_f = c3d_feature_stats(model, fake, feature_layer)
        scores.append(frechet_distance(mu_r, cov_r, mu_f, cov_f))
    return {"mean": float(np.mean(scores)) if scores else float("nan"),
            "per_sample": scores, "pretrained": bool(weights_path),
            "feature_layer": feature_layer}
