"""Network modules (port of ``hpvaegan_tpu/models/networks.py``), 2D or 3D
through ``ndim``, on NCHW / NCDHW activations.

The port has what ``GeneratorHPVAEGAN`` and its critic run:
``reparameterize``, ``FeatureExtractor``, ``EncodeVAE``, ``Decoder``,
``Stage`` and ``WDiscriminator``.  The baselines' critic, the
``_nb``/``1x1`` encoders and the baseline stages are ROADMAP items.  Every
module takes its input channel count explicitly (PyTorch modules own their
weights at construction).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.kernels.conv3d_fuse import conv3d64_pair
from .blocks import (ConvBlock, ConvND, SNConv, _to_nthwc, k1_geometry,
                     to_thwio)

__all__ = ["reparameterize", "FeatureExtractor", "EncodeVAE", "Decoder",
           "Stage", "WDiscriminator"]


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

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """``update_stats``: move the BatchNorm running statistics towards
        this batch's (training forwards that keep their updates)."""
        x = self.head(x, train, update_stats)
        for block in self.blocks:
            x = block(x, train, update_stats)
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


class WDiscriminator(nn.Module):
    """Patch WGAN critic: SN head 3 -> nfc, ``num_layer`` SN body convs,
    linear tail nfc -> 1; a per-patch score map with no pooling
    (``hpvaegan_tpu/models/networks.py:228-286``, networks_3d.py:163-181).
    The tail's padding is hard-coded to 1 whatever ``ker_size`` is: a
    reference quirk, kept.

    Kernel routes: under ``pfuse`` consecutive body pairs of K2's geometry
    run fused on K2 (``ops/kernels/conv3d_fuse.py``) from the pair's
    ``SNConv.normalized`` weights, keeping each block's own variables;
    an odd trailing block, and every body block without ``pfuse``, runs
    on K1 under ``pconv``.  ``forward(x, use_kernels=False)`` runs the
    same weights on stock convs only: the counterpart of the JAX
    package's ``D.clone(pconv=False, pfuse=False)``, which the WGAN-GP's
    double backprop uses (``train/steps.py:316-323``)."""

    def __init__(self, nc_im: int, nfc: int, ker_size: int, num_layer: int,
                 ndim: int = 2, pconv: bool = False, pfuse: bool = False):
        super().__init__()
        pad = ker_size // 2
        self.num_layer = num_layer
        self.head = SNConv(nc_im, nfc, ker_size, pad, ndim)
        self.body = nn.ModuleList(
            SNConv(nfc, nfc, ker_size, pad, ndim, pconv=pconv)
            for _ in range(num_layer))
        self.tail = ConvND(nfc, 1, ker_size, 1, ndim)
        self.pfuse = pfuse and k1_geometry(ndim, ker_size, 1, pad, nfc,
                                           nfc)

    def reset_parameters(self, generator=None):
        _reset((self.head, *self.body, self.tail), generator)

    def sn_convs(self):
        return [self.head, *self.body]

    def forward(self, x: torch.Tensor, use_kernels: bool = True
                ) -> torch.Tensor:
        x = self.head(x)
        i = 0
        while i < self.num_layer:
            if use_kernels and self.pfuse and i + 1 < self.num_layer:
                w1, b1 = self.body[i].normalized()
                w2, b2 = self.body[i + 1].normalized()
                y = conv3d64_pair(_to_nthwc(x), to_thwio(w1), b1,
                                  to_thwio(w2), b2)
                x = y.permute(0, 4, 1, 2, 3)
                i += 2
            else:
                x = self.body[i](x, use_kernels)
                i += 1
        return self.tail(x)
