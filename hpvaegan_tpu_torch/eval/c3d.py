"""C3D feature backbone for SVFID (port of ``hpvaegan_tpu/eval/c3d.py``;
Tran et al., ICCV 2015, arXiv 1412.0767).

The conv stack only, conv1..conv5b with the standard max-pool schedule,
each conv's post-ReLU map a tap (SVFID takes statistics over feature-map
positions; the fc head is not needed).  ``C3D(feature_layer)`` builds the
layers up to its tap and takes NCDHW input; the public functions take
the JAX package's NTHWC clips.

Parameters travel as the JAX package's trees, numpy arrays in flax's
layout (``{"params": {"conv1": {"kernel": (3,3,3,I,O), "bias": (O,)},
...}}``), converted to PyTorch's ``(O, I, 3, 3, 3)`` in
``utils/convert.py``:

* ``load_c3d_torch`` reads a Sports-1M C3D state dict (the widely
  mirrored ``c3d-pretrained.pth``, or the legacy pickled full module);
* ``random_c3d_params`` draws the fixed-seed random C3D, the fallback
  without weights, as flax draws it (``eval/jax_init.py``): the port's
  random trunk is the JAX package's, weight for weight.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import jax_init

__all__ = ["C3D", "C3D_LAYERS", "preprocess", "load_c3d_torch",
           "random_c3d_params"]

# conv name -> features.  All convs 3x3x3 / stride 1 / pad 1 / ReLU
C3D_LAYERS: Tuple[Tuple[str, int], ...] = (
    ("conv1", 64),
    ("conv2", 128),
    ("conv3a", 256),
    ("conv3b", 256),
    ("conv4a", 512),
    ("conv4b", 512),
    ("conv5a", 512),
    ("conv5b", 512),
)

# maxpool window preceding each conv group (stride == window, no padding)
_PRE_POOL = {
    "conv1": None,
    "conv2": (1, 2, 2),
    "conv3a": (2, 2, 2),
    "conv4a": (2, 2, 2),
    "conv5a": (2, 2, 2),
}

# Sports-1M channel means in BGR order
_C3D_MEAN_BGR = (90.0, 98.0, 102.0)


def preprocess(video_pm1: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NTHWC -> C3D input (0..255 BGR, mean-subtracted)."""
    x = (video_pm1 + 1.0) * 127.5
    x = x.flip(-1)  # RGB -> BGR
    return x - torch.tensor(_C3D_MEAN_BGR, dtype=x.dtype, device=x.device)


def _layer_names() -> list:
    return [name for name, _ in C3D_LAYERS]


class C3D(nn.Module):
    """C3D conv stack up to ``feature_layer``; ``forward`` takes the
    preprocessed NCDHW clip and returns the tap's post-ReLU map."""

    def __init__(self, feature_layer: str = "conv3b"):
        super().__init__()
        if feature_layer not in _layer_names():
            raise ValueError(f"unknown C3D layer {feature_layer!r}; "
                             f"choose from {_layer_names()}")
        self.feature_layer = feature_layer
        self.layers = []
        in_ch = 3
        for name, features in C3D_LAYERS:
            self.add_module(name, nn.Conv3d(in_ch, features, 3, padding=1))
            self.layers.append(name)
            in_ch = features
            if name == feature_layer:
                break

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layers:
            window = _PRE_POOL.get(name)
            if window is not None:
                x = F.max_pool3d(x, window, window)
            x = F.relu(getattr(self, name)(x))
        return x


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_c3d_torch(weights_path: str, feature_layer: str) -> Dict[str, Any]:
    """A torch C3D state dict -> the JAX package's parameter tree (numpy,
    flax layout), the layers up to ``feature_layer``.

    Expected checkpoint: keys ``conv1.weight/bias`` .. ``conv5b.weight/
    bias`` (optionally ``module.``-prefixed), weights ``(O, I, 3, 3, 3)``
    as ``C3D_LAYERS`` says; fc keys are ignored.  The file's sha256 is
    logged on every load, and ``$C3D_WEIGHTS_SHA256`` pins it (a mismatch
    raises).  The file is read with ``weights_only=True``; a legacy
    pickled full module falls back to ``weights_only=False``, with a
    warning."""
    digest = _file_sha256(weights_path)
    expected = os.environ.get("C3D_WEIGHTS_SHA256", "")
    if expected and digest != expected.lower():
        raise ValueError(f"C3D checkpoint sha256 mismatch: {weights_path} "
                         f"has {digest}, $C3D_WEIGHTS_SHA256 pins "
                         f"{expected}")
    logging.info(f"C3D weights {weights_path}: sha256 {digest}")

    try:
        state = torch.load(weights_path, map_location="cpu",
                           weights_only=True)
    except Exception:
        logging.warning(
            f"C3D checkpoint {weights_path} is not a plain state dict — "
            f"falling back to weights_only=False (executes pickled code; "
            f"only do this for files you trust)")
        state = torch.load(weights_path, map_location="cpu",
                           weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}

    params: Dict[str, Any] = {}
    in_ch = 3
    for name, features in C3D_LAYERS:
        wkey = f"{name}.weight"
        if wkey not in state:
            raise KeyError(f"C3D checkpoint missing {wkey!r} "
                           f"(found keys like {sorted(state)[:4]})")
        w = np.asarray(state[wkey], np.float32)
        b = np.asarray(state[f"{name}.bias"], np.float32)
        want_w = (features, in_ch, 3, 3, 3)
        if w.shape != want_w or b.shape != (features,):
            raise ValueError(
                f"C3D checkpoint {name} has shape {w.shape}/{b.shape}, "
                f"expected {want_w}/({features},) — not a Sports-1M C3D "
                f"state dict")
        params[name] = {"kernel": w.transpose(2, 3, 4, 1, 0), "bias": b}
        in_ch = features
        if name == feature_layer:
            break
    return {"params": params}


def random_c3d_params(feature_layer: str, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's fixed-seed random C3D: lecun-normal kernels drawn
    from ``PRNGKey(seed)`` as flax draws them, zero biases."""
    if feature_layer not in _layer_names():
        raise ValueError(f"unknown C3D layer {feature_layer!r}; "
                         f"choose from {_layer_names()}")
    root = jax_init.prng_key(seed)
    params: Dict[str, Any] = {}
    in_ch = 3
    for name, features in C3D_LAYERS:
        params[name] = {
            "kernel": jax_init.lecun_normal(
                jax_init.flax_param_key(root, name),
                (3, 3, 3, in_ch, features)),
            "bias": np.zeros(features, np.float32)}
        in_ch = features
        if name == feature_layer:
            break
    return {"params": params}
