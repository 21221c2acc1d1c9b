"""Network modules (port of ``hpvaegan_tpu/models/networks.py``), 2D or 3D
through ``ndim``, on NCHW / NCDHW activations.

This slice ports what ``GeneratorHPVAEGAN`` runs: ``reparameterize``,
``FeatureExtractor``, ``EncodeVAE``, ``Decoder`` and ``Stage``.  The
critics, the ``_nb``/``1x1`` encoders and the baseline stages are ROADMAP
items.  Every module takes its input channel count explicitly (PyTorch
modules own their weights at construction).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .blocks import ConvBlock, ConvND, SNConv

__all__ = ["reparameterize", "FeatureExtractor", "EncodeVAE", "Decoder",
           "Stage"]


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, training: bool,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """VAE trick; NOTE eval mode returns pure N(0,1) noise, not mu — a
    deliberate reference quirk (networks_3d.py:29-35).  ``eps`` is the
    N(0,1) draw (shaped like ``mu``); drawn from ``generator`` when None."""
    if eps is None:
        eps = torch.randn(mu.shape, dtype=mu.dtype, device=mu.device,
                          generator=generator)
    if training:
        return eps * torch.exp(0.5 * logvar) + mu
    return eps


def _reset(modules, generator):
    for m in modules:
        m.reset_parameters(generator)


class FeatureExtractor(nn.Module):
    """num_blocks+1 stacked SN conv blocks (networks_3d.py:73-85).  The
    JAX module's ``return_linear`` tail is set by no caller and is not
    ported."""

    def __init__(self, in_features: int, nfc: int, ker_size: int,
                 padding: int, num_blocks: int = 2, ndim: int = 2):
        super().__init__()
        ins = [in_features] + [nfc] * num_blocks
        self.conv_blocks = nn.ModuleList(
            SNConv(ins[i], nfc, ker_size, padding, ndim)
            for i in range(num_blocks + 1))

    def reset_parameters(self, generator=None):
        _reset(self.conv_blocks, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.conv_blocks:
            x = block(x)
        return x


class EncodeVAE(nn.Module):
    """Fully-convolutional VAE encoder: mu/logvar are spatial maps
    (networks_3d.py:88-107)."""

    def __init__(self, in_features: int, latent_dim: int, nfc: int,
                 ker_size: int, enc_blocks: int = 2, ndim: int = 2):
        super().__init__()
        pad = ker_size // 2
        self.features = FeatureExtractor(in_features, nfc, ker_size, pad,
                                         num_blocks=enc_blocks, ndim=ndim)
        self.mu = ConvND(nfc, latent_dim, ker_size, pad, ndim)
        self.logvar = ConvND(nfc, latent_dim, ker_size, pad, ndim)

    def reset_parameters(self, generator=None):
        _reset((self.features, self.mu, self.logvar), generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(x)
        return self.mu(feats), self.logvar(feats)


class _ConvStack(nn.Module):
    """head ConvBlock + num_layer ConvBlocks + linear tail conv: the shared
    structure of the VAE decoder and of every refinement stage
    (networks_3d.py:337-363).  Output is raw; the caller applies tanh."""

    def __init__(self, in_features: int, nfc: int, nc_im: int,
                 ker_size: int, padd_size: int, num_layer: int,
                 ndim: int = 2, pconv: bool = False):
        super().__init__()
        self.head = ConvBlock(in_features, nfc, ker_size, padd_size, ndim,
                              pconv=pconv)
        self.blocks = nn.ModuleList(
            ConvBlock(nfc, nfc, ker_size, padd_size, ndim, pconv=pconv)
            for _ in range(num_layer))
        self.tail = ConvND(nfc, nc_im, ker_size, ker_size // 2, ndim)

    def reset_parameters(self, generator=None):
        _reset((self.head, *self.blocks, self.tail), generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.head(x, train)
        for block in self.blocks:
            x = block(x, train)
        return self.tail(x)


class Decoder(_ConvStack):
    """VAE decoder conv stack (networks_3d.py:337-341): latent_dim in."""

    def __init__(self, latent_dim: int, nfc: int, nc_im: int, ker_size: int,
                 padd_size: int, num_layer: int, ndim: int = 2):
        super().__init__(latent_dim, nfc, nc_im, ker_size, padd_size,
                         num_layer, ndim)


class Stage(_ConvStack):
    """One refinement body stage, image to image (networks_3d.py:352-363).
    With ``pconv`` its 64 -> 64 block convs run on the K1 kernel."""

    def __init__(self, nfc: int, nc_im: int, ker_size: int, padd_size: int,
                 num_layer: int, ndim: int = 2, pconv: bool = False):
        super().__init__(nc_im, nfc, nc_im, ker_size, padd_size, num_layer,
                         ndim, pconv)
