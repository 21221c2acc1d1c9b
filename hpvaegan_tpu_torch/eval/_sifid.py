"""SIFID — Single-Image Frechet Inception Distance (port of
``hpvaegan_tpu/eval/_sifid.py``; SinGAN, arXiv 1905.01164).

The 2D counterpart of SVFID (``_svfid.py``): every (h, w) site of an
internal map of Inception-v3's first block — Conv2d_1a_3x3 (s2),
Conv2d_2a_3x3, Conv2d_2b_3x3 (p1), maxpool(3, s2), 64 channels, the
canonical SIFID tap ``pool1`` — is one sample, at the image's native
resolution.

Weights: a torchvision ``inception_v3`` state dict through
``weights_path`` (or ``$INCEPTION_WEIGHTS``), its eval-mode BatchNorm
folded into the convs in float64; without one, the fixed-seed random
stem that the JAX package draws (``random_stem_params``).  Features run
on ``device`` in f32 with TF32 off, statistics in float64 on the host;
the built stem is cached per (tap, seed, weights, device).
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..utils import convert
from . import jax_init
from ._svfid import _device_key, _positions, _stats, frechet_distance
from .c3d import _file_sha256

__all__ = ["InceptionStem", "STEM_LAYERS", "SIFID_TAPS",
           "image_feature_stats", "sifid", "load_inception_torch",
           "random_stem_params", "build_stem"]

log = logging.getLogger(__name__)

# conv name -> (features, stride, symmetric pad); all kernels 3x3, each
# conv followed by ReLU (BatchNorm folded in)
STEM_LAYERS: Tuple[Tuple[str, int, int, int], ...] = (
    ("Conv2d_1a_3x3", 32, 2, 0),
    ("Conv2d_2a_3x3", 32, 1, 0),
    ("Conv2d_2b_3x3", 64, 1, 1),
)

# each conv's post-ReLU map, or "pool1", the maxpool(3, s2) of the last
SIFID_TAPS = tuple(name for name, _, _, _ in STEM_LAYERS) + ("pool1",)


def _tap_min_hw(tap: str) -> int:
    """Smallest square input the tap's valid convs/pool can consume:
    per layer (kernel 3) ``(need - 1) * stride + 3 - 2 * pad``."""
    need = 3 if tap == "pool1" else 1  # pool window
    seen = tap == "pool1"
    for name, _, stride, pad in reversed(STEM_LAYERS):
        if not seen and name != tap:
            continue
        seen = True
        need = (need - 1) * stride + 3 - 2 * pad
    return need


def _check_tap(tap: str) -> None:
    if tap not in SIFID_TAPS:
        raise ValueError(f"unknown SIFID tap {tap!r}; "
                         f"choose from {SIFID_TAPS}")


def _stem_convs(tap: str):
    """The (name, features, stride, pad) of the convs ``tap`` needs."""
    for layer in STEM_LAYERS:
        yield layer
        if layer[0] == tap:
            return


class InceptionStem(nn.Module):
    """Inception-v3's first block up to ``tap``; ``forward`` takes NCHW
    input in [-1, 1] (the preprocessing is the identity) and returns the
    tap's map."""

    def __init__(self, tap: str = "pool1"):
        super().__init__()
        _check_tap(tap)
        self.tap = tap
        self.layers = []
        in_ch = 3
        for name, features, stride, pad in _stem_convs(tap):
            self.add_module(name, nn.Conv2d(in_ch, features, 3, stride,
                                            pad))
            self.layers.append(name)
            in_ch = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layers:
            x = F.relu(getattr(self, name)(x))
        if self.tap == "pool1":
            x = F.max_pool2d(x, 3, 2)
        return x


def build_stem(params, tap: str, device="cuda") -> InceptionStem:
    """An ``InceptionStem`` up to ``tap`` holding ``params`` on
    ``device``, in eval mode."""
    model = InceptionStem(tap)
    convert.load_feature_convs(model, params)
    return model.to(resolve_device(device)).eval()


@functools.lru_cache(maxsize=None)
def _stem(tap: str, seed: int, weights_path: str,
          device: str) -> InceptionStem:
    params = (load_inception_torch(weights_path, tap) if weights_path
              else random_stem_params(tap, seed))
    return build_stem(params, tap, device)


def image_feature_stats(params, image_pm1: np.ndarray, tap: str = "pool1",
                        device="cuda"):
    """(mu, cov) over feature-map positions of one [-1,1] NHWC image,
    (H, W, 3) or (1, H, W, 3).  ``params`` is a parameter tree (run on
    ``device``) or a built ``InceptionStem`` (run where it lies)."""
    x = torch.as_tensor(np.asarray(image_pm1, np.float32))
    if x.dim() == 3:
        x = x[None]
    min_hw = _tap_min_hw(tap)
    if x.shape[1] < min_hw or x.shape[2] < min_hw:
        raise ValueError(f"image {tuple(x.shape[1:3])} too small for SIFID "
                         f"tap {tap!r} (needs H,W>={min_hw})")
    model = (params if isinstance(params, InceptionStem)
             else build_stem(params, tap, device))
    return _stats(_positions(model, x))


def load_inception_torch(weights_path: str, tap: str) -> Dict[str, Any]:
    """A torchvision ``inception_v3`` state dict -> the stem's parameter
    tree (numpy, flax layout), eval-mode BatchNorm folded into each conv
    in float64: ``w' = w * g / sqrt(v + 1e-3)``, ``b' = b_bn - m * g /
    sqrt(v + 1e-3)``.  Keys ``<conv>.conv.weight`` and ``<conv>.bn.
    {weight,bias,running_mean,running_var}``; the file's sha256 is logged,
    ``$INCEPTION_WEIGHTS_SHA256`` pins it.  Layers up to ``tap``, each
    shape-checked."""
    digest = _file_sha256(weights_path)
    expected = os.environ.get("INCEPTION_WEIGHTS_SHA256", "")
    if expected and digest != expected.lower():
        raise ValueError(f"Inception checkpoint sha256 mismatch: "
                         f"{weights_path} has {digest}, "
                         f"$INCEPTION_WEIGHTS_SHA256 pins {expected}")
    log.info(f"Inception weights {weights_path}: sha256 {digest}")

    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}

    params: Dict[str, Any] = {}
    in_ch = 3
    for name, features, _, _ in STEM_LAYERS:
        wkey = f"{name}.conv.weight"
        if wkey not in state:
            raise KeyError(f"Inception checkpoint missing {wkey!r} "
                           f"(found keys like {sorted(state)[:4]})")
        w = np.asarray(state[wkey], np.float64)  # (O, I, kH, kW)
        want_w = (features, in_ch, 3, 3)
        if w.shape != want_w:
            raise ValueError(f"Inception checkpoint {name} has shape "
                             f"{w.shape}, expected {want_w} — not a "
                             f"torchvision inception_v3 state dict")
        g = np.asarray(state[f"{name}.bn.weight"], np.float64)
        b = np.asarray(state[f"{name}.bn.bias"], np.float64)
        m = np.asarray(state[f"{name}.bn.running_mean"], np.float64)
        v = np.asarray(state[f"{name}.bn.running_var"], np.float64)
        scale = g / np.sqrt(v + 1e-3)
        params[name] = {
            "kernel": (w * scale[:, None, None, None]).transpose(
                2, 3, 1, 0).astype(np.float32),
            "bias": (b - m * scale).astype(np.float32),
        }
        in_ch = features
        if name == tap:
            break
    return {"params": params}


def random_stem_params(tap: str, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's fixed-seed random stem: lecun-normal kernels
    drawn from ``PRNGKey(seed)`` as flax draws them, zero biases."""
    _check_tap(tap)
    root = jax_init.prng_key(seed)
    params: Dict[str, Any] = {}
    in_ch = 3
    for name, features, _, _ in _stem_convs(tap):
        params[name] = {
            "kernel": jax_init.lecun_normal(
                jax_init.flax_param_key(root, name),
                (3, 3, in_ch, features)),
            "bias": np.zeros(features, np.float32)}
        in_ch = features
    return {"params": params}


def sifid(real_image: np.ndarray, fake_images: Sequence[np.ndarray],
          weights_path: Optional[str] = None, tap: str = "pool1",
          seed: int = 0, device="cuda") -> dict:
    """SIFID of each fake against the single real image.

    Returns ``{"mean": float, "per_sample": [float, ...],
    "pretrained": bool, "tap": str}``, the contract of ``svfid``."""
    weights_path = weights_path or os.environ.get("INCEPTION_WEIGHTS", "")
    if not weights_path:
        log.warning(
            "SIFID: no pretrained Inception weights (set $INCEPTION_WEIGHTS "
            "or pass weights_path) — using a fixed-seed RANDOM stem. Scores "
            "are deterministic and comparable to each other but NOT to "
            "published SIFID numbers.")
    model = _stem(tap, int(seed), weights_path, _device_key(device))
    mu_r, cov_r = image_feature_stats(model, real_image, tap)
    scores = []
    for fake in fake_images:
        mu_f, cov_f = image_feature_stats(model, fake, tap)
        scores.append(frechet_distance(mu_r, cov_r, mu_f, cov_f))
    return {"mean": float(np.mean(scores)) if scores else float("nan"),
            "per_sample": scores, "pretrained": bool(weights_path),
            "tap": tap}
