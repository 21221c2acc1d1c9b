"""JAX package variables -> the port's modules (no JAX counterpart).

Input is the JAX package's generator variables (``load_generator``),
critic variables (``load_discriminator``) or the eval trunks' parameter
trees (``load_feature_convs``: C3D, the Inception stem) as nested dicts
of numpy arrays.  The generator's are
``{"encode": vars, "decoder": vars, "body": [vars, ...]}`` for
``GeneratorHPVAEGAN`` and ``GeneratorVAE_nb`` (whose encoder adds the
``bern`` conv), ``{"head": vars, "tail": vars, "body": [...]}`` for
``GeneratorCSG`` and ``{"body": [...]}`` for ``GeneratorSG``
(``hpvaegan_tpu/models/generators.py:145-164, 454-459, 508-512``), each
``vars`` a flax variable dict with ``params`` and, where the module has
them, ``batch_stats`` and ``spectral``.  Flax auto-names a
``ConvBlock``'s conv ``ConvND_0``, so a block's kernel sits at
``<block>/ConvND_0/conv/kernel``; a block without norm (the baselines
critic's head) has no ``norm`` entry.

Layouts are converted here and nowhere else:
* flax conv kernels ``(*k, I, O)`` become PyTorch's ``(O, I, *k)``, or stay
  THWIO for a conv routed to the K1 kernel (``ConvND.kernel_route``);
* BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_*``;
* spectral-norm ``u`` is copied and ``v`` is re-ordered from flax's
  ``(*k, I)`` flattening to the ``(I, *k)`` flattening of
  ``weight.reshape(O, -1)``, so ``sigma = u @ (W v)`` is unchanged.

An optax Adam moment (``mu``/``nu`` of a JAX ``netG_mid``) is a tree
shaped like the parameters it moves, with ``{}`` where a group's mask
leaves a parameter out.  ``generator_moments``/``critic_moments`` lay it
out as its parameters: they load a copy of the module whose parameters
are the moment's (the masked ones taken from the variables) through the
loaders above, so a moment takes exactly its parameter's layout.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.blocks import ConvBlock, ConvND, SNConv
from ..models.networks import WDiscriminatorBaselines

__all__ = ["load_conv", "load_conv_block", "load_snconv", "load_encoder",
           "load_conv_stack", "load_csg_stage", "load_generator",
           "load_discriminator", "load_feature_convs", "generator_moments",
           "critic_moments"]


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
    if m.norm is None:
        return
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
    """``EncodeVAE``, ``EncodeVAE_nb`` or ``EncodeVAE1x1`` <- flax vars
    ``{"params", "spectral"}``."""
    p, s = v["params"], v["spectral"]
    for i, block in enumerate(m.features.conv_blocks):
        name = f"conv_block_{i}"
        load_snconv(block, p["features"][name], s["features"][name])
    if hasattr(m, "bern"):
        load_conv(m.bern, p["bern"]["conv"])
    load_conv(m.mu, p["mu"]["conv"])
    load_conv(m.logvar, p["logvar"]["conv"])


def load_conv_stack(m, v: Mapping[str, Any]) -> None:
    """``Decoder``/``Stage`` <- flax vars ``{"params", "batch_stats"}``."""
    p, bs = v["params"], v["batch_stats"]
    load_conv_block(m.head, p["head"], bs["head"])
    for i, block in enumerate(m.blocks):
        load_conv_block(block, p[f"block{i}"], bs[f"block{i}"])
    load_conv(m.tail, p["tail"]["conv"])


def load_csg_stage(m, v: Mapping[str, Any]) -> None:
    """``CSGStage`` <- flax vars ``{"params", "batch_stats"}``
    (``block{i}``)."""
    for i, block in enumerate(m.blocks):
        load_conv_block(block, v["params"][f"block{i}"],
                        v["batch_stats"][f"block{i}"])


def _stages(body) -> list:
    """A generator's ``body``: a list, or a ``{"0": ...}`` map as read
    from a flax-msgpack file."""
    return ([body[k] for k in sorted(body, key=int)]
            if isinstance(body, Mapping) else list(body))


def load_generator(G, gvars: Mapping[str, Any]) -> None:
    """Fill any port generator from JAX ``gvars``; grows ``G``'s body
    (stage copies) to the number of JAX stages first.  The body may be a
    list or, as read from a flax-msgpack file, a ``{"0": ...}`` map."""
    body = _stages(gvars["body"])
    if len(G.body) > len(body):
        raise ValueError(f"port generator has {len(G.body)} stages, the "
                         f"JAX variables {len(body)}")
    while len(G.body) < len(body):
        G.init_next_stage()
    if hasattr(G, "encode"):
        load_encoder(G.encode, gvars["encode"])
        load_conv_stack(G.decoder, gvars["decoder"])
    if getattr(G, "has_head_tail", False):
        head = gvars["head"]
        load_conv_block(G.head, head["params"], head["batch_stats"])
        load_conv(G.tail, gvars["tail"]["params"]["conv"])
        for stage, v in zip(G.body, body):
            load_csg_stage(stage, v)
        return
    for stage, v in zip(G.body, body):
        load_conv_stack(stage, v)


def load_discriminator(D, dvars: Mapping[str, Any]) -> None:
    """Fill a port ``WDiscriminator`` from the JAX critic variables
    ``{"params", "spectral"}`` (``head``, ``block{i}``, ``tail/conv``), or
    a ``WDiscriminatorBaselines`` from ``{"params", "batch_stats"}``."""
    if isinstance(D, WDiscriminatorBaselines):
        p, bs = dvars["params"], dvars["batch_stats"]
        load_conv_block(D.head, p["head"], {})
        for i, block in enumerate(D.body):
            load_conv_block(block, p[f"block{i}"], bs[f"block{i}"])
        load_conv(D.tail, p["tail"]["conv"])
        return
    p, s = dvars["params"], dvars["spectral"]
    load_snconv(D.head, p["head"], s["head"])
    for i, block in enumerate(D.body):
        load_snconv(block, p[f"block{i}"], s[f"block{i}"])
    load_conv(D.tail, p["tail"]["conv"])


def load_feature_convs(m, tree: Mapping[str, Any]) -> None:
    """Fill the convs of an eval trunk (``eval/c3d.C3D``,
    ``eval/_sifid.InceptionStem``) from its parameter tree
    ``{"params": {name: {"kernel": (*k, I, O), "bias": (O,)}}}``; every
    conv of ``m`` must be in the tree."""
    p = tree["params"]
    for name in m.layers:
        conv = getattr(m, name)
        _copy(conv.weight, _t(_kernel_to_oi(np.asarray(p[name]["kernel"]))))
        _copy(conv.bias, _t(p[name]["bias"]))


def _filled(moment, params):
    """``moment`` with each leaf that a mask left out (``{}``, or absent)
    taken from ``params``, the tree both are shaped like."""
    if isinstance(params, Mapping):
        moment = moment if isinstance(moment, Mapping) else {}
        return {k: _filled(moment.get(k, {}), v) for k, v in params.items()}
    return params if isinstance(moment, Mapping) else moment


def _with_params(variables: Mapping[str, Any], moment) -> dict:
    return {**variables, "params": _filled(moment, variables["params"])}


def _named(m) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in m.named_parameters()}


def generator_moments(G, gvars: Mapping[str, Any],
                      moment: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An Adam moment of the JAX generator's params view (``{"encode":
    params, "decoder": params, "body": [params, ...]}``, or the
    baselines' keys) as tensors by ``G``'s parameter names, each in its
    parameter's layout; ``G`` is left as it is."""
    tree = {}
    for key, value in gvars.items():
        if key == "body":
            parts = _stages(moment.get("body", []))
            tree["body"] = [_with_params(v, parts[i] if i < len(parts)
                                         else {})
                            for i, v in enumerate(_stages(value))]
        else:
            tree[key] = _with_params(value, moment.get(key, {}))
    twin = copy.deepcopy(G)
    load_generator(twin, tree)
    return _named(twin)


def critic_moments(D, dvars: Mapping[str, Any],
                   moment: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An Adam moment of the JAX critic's params as tensors by ``D``'s
    parameter names, each in its parameter's layout."""
    twin = copy.deepcopy(D)
    load_discriminator(twin, _with_params(dvars, moment))
    return _named(twin)
