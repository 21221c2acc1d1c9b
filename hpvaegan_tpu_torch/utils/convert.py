"""JAX package variables -> the port's modules (no JAX counterpart).

Input is the JAX package's generator variables (``load_generator``) or
critic variables (``load_discriminator``) as nested dicts of numpy
arrays.  The generator's are
``{"encode": vars, "decoder": vars, "body": [vars, ...]}``
(``hpvaegan_tpu/models/generators.py:145-164``), each ``vars`` a flax
variable dict with ``params`` and, where the module has them,
``batch_stats`` and ``spectral``.  Flax auto-names a ``ConvBlock``'s conv
``ConvND_0``, so a block's kernel sits at ``<block>/ConvND_0/conv/kernel``.

Layouts are converted here and nowhere else:
* flax conv kernels ``(*k, I, O)`` become PyTorch's ``(O, I, *k)``, or stay
  THWIO for a conv routed to the K1 kernel (``ConvND.kernel_route``);
* BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_*``;
* spectral-norm ``u`` is copied and ``v`` is re-ordered from flax's
  ``(*k, I)`` flattening to the ``(I, *k)`` flattening of
  ``weight.reshape(O, -1)``, so ``sigma = u @ (W v)`` is unchanged.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..models.blocks import ConvBlock, ConvND, SNConv

__all__ = ["load_conv", "load_conv_block", "load_snconv", "load_encoder",
           "load_conv_stack", "load_generator", "load_discriminator"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)  # a copy


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"shape mismatch: {tuple(dst.shape)} <- "
                         f"{tuple(src.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _kernel_to_oi(kernel: np.ndarray) -> np.ndarray:
    """flax (*k, I, O) -> torch (O, I, *k)."""
    nd = kernel.ndim - 2
    return np.transpose(kernel, (nd + 1, nd, *range(nd)))


def load_conv(m: ConvND, p: Mapping[str, Any]) -> None:
    """``p``: the flax ``conv`` dict with ``kernel`` and ``bias``."""
    kernel = np.asarray(p["kernel"])
    _copy(m.weight, _t(kernel if m.kernel_route else _kernel_to_oi(kernel)))
    _copy(m.bias, _t(p["bias"]))


def load_conv_block(m: ConvBlock, p: Mapping[str, Any],
                    bs: Mapping[str, Any]) -> None:
    """``p``/``bs``: the block's ``params`` / ``batch_stats`` subtrees."""
    load_conv(m.conv, p["ConvND_0"]["conv"])
    _copy(m.norm.weight, _t(p["norm"]["scale"]))
    _copy(m.norm.bias, _t(p["norm"]["bias"]))
    _copy(m.norm.running_mean, _t(bs["norm"]["mean"]))
    _copy(m.norm.running_var, _t(bs["norm"]["var"]))


def load_snconv(m: SNConv, p: Mapping[str, Any],
                s: Mapping[str, Any]) -> None:
    """``p``: ``kernel``/``bias``; ``s``: the ``spectral`` ``u``/``v``."""
    kernel = np.asarray(p["kernel"])
    _copy(m.weight, _t(_kernel_to_oi(kernel)))
    _copy(m.bias, _t(p["bias"]))
    _copy(m.u, _t(s["u"]))
    v = np.asarray(s["v"]).reshape(kernel.shape[:-1])   # (*k, I)
    _copy(m.v, _t(np.moveaxis(v, -1, 0).reshape(-1)))   # (I, *k) flat


def load_encoder(m, v: Mapping[str, Any]) -> None:
    """``EncodeVAE`` <- flax vars ``{"params", "spectral"}``."""
    p, s = v["params"], v["spectral"]
    for i, block in enumerate(m.features.conv_blocks):
        name = f"conv_block_{i}"
        load_snconv(block, p["features"][name], s["features"][name])
    load_conv(m.mu, p["mu"]["conv"])
    load_conv(m.logvar, p["logvar"]["conv"])


def load_conv_stack(m, v: Mapping[str, Any]) -> None:
    """``Decoder``/``Stage`` <- flax vars ``{"params", "batch_stats"}``."""
    p, bs = v["params"], v["batch_stats"]
    load_conv_block(m.head, p["head"], bs["head"])
    for i, block in enumerate(m.blocks):
        load_conv_block(block, p[f"block{i}"], bs[f"block{i}"])
    load_conv(m.tail, p["tail"]["conv"])


def load_generator(G, gvars: Mapping[str, Any]) -> None:
    """Fill a port ``GeneratorHPVAEGAN`` from JAX ``gvars``; grows ``G``'s
    body (stage copies) to the number of JAX stages first.  The body may
    be a list or, as read from a flax-msgpack file, a ``{"0": ...}`` map."""
    body = gvars["body"]
    body = ([body[k] for k in sorted(body, key=int)]
            if isinstance(body, Mapping) else list(body))
    if len(G.body) > len(body):
        raise ValueError(f"port generator has {len(G.body)} stages, the "
                         f"JAX variables {len(body)}")
    while len(G.body) < len(body):
        G.init_next_stage()
    load_encoder(G.encode, gvars["encode"])
    load_conv_stack(G.decoder, gvars["decoder"])
    for stage, v in zip(G.body, body):
        load_conv_stack(stage, v)


def load_discriminator(D, dvars: Mapping[str, Any]) -> None:
    """Fill a port ``WDiscriminator`` from the JAX critic variables
    ``{"params", "spectral"}`` (``head``, ``block{i}``, ``tail/conv``)."""
    p, s = dvars["params"], dvars["spectral"]
    load_snconv(D.head, p["head"], s["head"])
    for i, block in enumerate(D.body):
        load_snconv(block, p[f"block{i}"], s[f"block{i}"])
    load_conv(D.tail, p["tail"]["conv"])
