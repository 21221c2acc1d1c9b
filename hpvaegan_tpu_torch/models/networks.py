"""Network modules (port of ``hpvaegan_tpu/models/networks.py``), 2D or 3D
through ``ndim``, on NCHW / NCDHW activations.

The whole zoo of the JAX module: ``reparameterize`` and
``reparameterize_bern``, ``FeatureExtractor``, the encoders ``EncodeVAE``,
``EncodeVAE_nb`` and ``EncodeVAE1x1``, ``Decoder``, ``Stage``, the SN
critic ``WDiscriminator``, and the baselines' ``WDiscriminatorBaselines``,
``CSGStage`` and ``SGStage`` (N(0, 0.02) init, VALID convs).  Every
module takes its input channel count explicitly (PyTorch modules own their
weights at construction), and ``dtype``, the compute dtype of its convs
(None: f32; ``torch.bfloat16`` under ``--bf16``), as the JAX modules take
flax's ``dtype``.

Under a mesh (``parallel.mesh.attach``; the JAX modules' ``mesh`` field,
``networks.py:206-221, 239-281``) every conv and BatchNorm of a module
runs on this rank's block (``models/blocks.py``).

``--remat-blocks`` (``remat_blocks``/``remat="blocks"``; JAX
``networks.py:180-182, 210-215, 255-257, 304-306, 334-335``): the conv
stacks, the baselines' stages and both critics run every conv block and
their tail conv under ``models/remat.remat``; the critics' ``remat``
also wraps their whole forward (``--remat``).  The fused K2 pair is not
wrapped on its own, as in the JAX package: the critic's forward is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.conv3d_fuse import conv3d64_pair
from .blocks import (ConvBlock, ConvND, SNConv, _cast, _to_nthwc,
                     k1_geometry, to_thwio)
from .remat import remat

__all__ = ["reparameterize", "reparameterize_bern", "FeatureExtractor",
           "EncodeVAE", "EncodeVAE_nb", "EncodeVAE1x1", "Decoder", "Stage",
           "WDiscriminator", "WDiscriminatorBaselines", "CSGStage",
           "SGStage"]


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, training: bool,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """VAE trick; NOTE eval mode returns pure N(0,1) noise, not mu — a
    deliberate reference quirk (networks_3d.py:29-35).  ``eps`` is the
    N(0,1) draw (shaped like ``mu``, taken in mu's dtype); drawn from
    ``generator`` when None."""
    if eps is None:
        eps = torch.randn(mu.shape, dtype=mu.dtype, device=mu.device,
                          generator=generator)
    eps = eps.to(mu.dtype)
    if training:
        return eps * torch.exp(0.5 * logvar) + mu
    return eps


def reparameterize_bern(x: torch.Tensor, training: bool,
                        eps: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Gumbel-style Bernoulli relaxation (networks_3d.py:38-43) of the
    probabilities ``x``.  Train mode: ``log(x) - log(-log(eps))`` over a
    U(0, 1) draw ``eps``; eval mode: a Bernoulli(``x``) sample, ``eps``
    being that 0/1 sample when handed in.  ``eps`` is shaped like ``x``
    and taken in its dtype; drawn from ``generator`` when None."""
    if eps is None:
        eps = (torch.rand(x.shape, dtype=x.dtype, device=x.device,
                          generator=generator) if training
               else torch.bernoulli(x.detach().float(),
                                    generator=generator))
    eps = eps.to(x.dtype)
    if training:
        return torch.log(x + 1e-20) - torch.log(
            -torch.log(eps + 1e-20) + 1e-20)
    return eps


def _reset(modules, generator):
    for m in modules:
        m.reset_parameters(generator)


class FeatureExtractor(nn.Module):
    """num_blocks+1 stacked SN conv blocks (networks_3d.py:73-85).  The
    JAX module's ``return_linear`` tail is set by no caller and is not
    ported."""

    def __init__(self, in_features: int, nfc: int, ker_size: int,
                 padding: int, num_blocks: int = 2, ndim: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ins = [in_features] + [nfc] * num_blocks
        self.conv_blocks = nn.ModuleList(
            SNConv(ins[i], nfc, ker_size, padding, ndim, dtype=dtype)
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
                 ker_size: int, enc_blocks: int = 2, ndim: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pad = ker_size // 2
        self.features = FeatureExtractor(in_features, nfc, ker_size, pad,
                                         num_blocks=enc_blocks, ndim=ndim,
                                         dtype=dtype)
        self.mu = ConvND(nfc, latent_dim, ker_size, pad, ndim, dtype=dtype)
        self.logvar = ConvND(nfc, latent_dim, ker_size, pad, ndim,
                             dtype=dtype)

    def reset_parameters(self, generator=None):
        _reset((self.features, self.mu, self.logvar), generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(x)
        return self.mu(feats), self.logvar(feats)


class EncodeVAE_nb(nn.Module):
    """Bernoulli-gated encoder with global latents (networks_3d.py:110-138):
    a sigmoid gate ``bern`` (one channel) scales the features, and ``mu``
    and ``logvar`` are averaged over the spatial axes (the reference's
    ``AdaptiveAvgPool(1)``).  Returns ``(mu, logvar, bern)``, the first two
    of spatial size 1.  Under a ``mesh`` with a spatial axis each mean is
    the block's sum, summed over the rank's spatial ring
    (``Mesh.ring_sum``, whose backward sums over the ring too), over the
    whole count: every rank of a ring holds the whole ``mu``/``logvar``
    of its batch rows."""

    mesh = None

    def __init__(self, in_features: int, latent_dim: int, nfc: int,
                 ker_size: int, enc_blocks: int = 2, ndim: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pad = ker_size // 2
        self.features = FeatureExtractor(in_features, nfc, ker_size, pad,
                                         num_blocks=enc_blocks, ndim=ndim,
                                         dtype=dtype)
        self.bern = ConvND(nfc, 1, ker_size, pad, ndim, dtype=dtype)
        self.mu = ConvND(nfc, latent_dim, ker_size, pad, ndim, dtype=dtype)
        self.logvar = ConvND(nfc, latent_dim, ker_size, pad, ndim,
                             dtype=dtype)

    def reset_parameters(self, generator=None):
        _reset((self.features, self.bern, self.mu, self.logvar), generator)

    def forward(self, x: torch.Tensor):
        feats = self.features(x)
        bern = torch.sigmoid(self.bern(feats))
        feats = bern * feats
        return (self._pool(self.mu(feats)), self._pool(self.logvar(feats)),
                bern)

    def _pool(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the spatial axes, of the whole H under a mesh
        (summed in f32, in ``t``'s dtype)."""
        spatial = tuple(range(2, t.dim()))
        if self.mesh is None or self.mesh.n_spatial == 1:
            return t.mean(dim=spatial, keepdim=True)
        count = self.mesh.ring_count(t[0, 0].numel())
        total = self.mesh.ring_sum(t.float().sum(dim=spatial, keepdim=True))
        return (total / count).to(t.dtype)


class EncodeVAE1x1(nn.Module):
    """The 1x1-kernel encoder (networks_3d.py:141-160): two SN blocks of
    1x1 convs and 1x1 ``mu``/``logvar`` maps.  In the zoo, used by no
    trainer (PARITY.md)."""

    def __init__(self, in_features: int, latent_dim: int, nfc: int,
                 ndim: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = FeatureExtractor(in_features, nfc, 1, 0,
                                         num_blocks=2, ndim=ndim,
                                         dtype=dtype)
        self.mu = ConvND(nfc, latent_dim, 1, 0, ndim, dtype=dtype)
        self.logvar = ConvND(nfc, latent_dim, 1, 0, ndim, dtype=dtype)

    def reset_parameters(self, generator=None):
        _reset((self.features, self.mu, self.logvar), generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(x)
        return self.mu(feats), self.logvar(feats)


class _ConvStack(nn.Module):
    """head ConvBlock + num_layer ConvBlocks + linear tail conv: the shared
    structure of the VAE decoder, of every refinement stage
    (networks_3d.py:337-363) and of a SinGAN stage (VALID, ``n002``).
    Output is raw; the caller applies tanh."""

    def __init__(self, in_features: int, nfc: int, nc_im: int,
                 ker_size: int, padd_size: int, num_layer: int,
                 ndim: int = 2, pconv: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 init_mode: str = "torch",
                 tail_padding: Optional[int] = None):
        super().__init__()
        self.head = ConvBlock(in_features, nfc, ker_size, padd_size, ndim,
                              pconv=pconv, dtype=dtype, init_mode=init_mode)
        self.blocks = nn.ModuleList(
            ConvBlock(nfc, nfc, ker_size, padd_size, ndim, pconv=pconv,
                      dtype=dtype, init_mode=init_mode)
            for _ in range(num_layer))
        self.tail = ConvND(nfc, nc_im, ker_size,
                           ker_size // 2 if tail_padding is None
                           else tail_padding, ndim, dtype=dtype,
                           init_mode=init_mode)

    def reset_parameters(self, generator=None):
        _reset((self.head, *self.blocks, self.tail), generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False,
                remat_blocks: bool = False) -> torch.Tensor:
        """``update_stats``: move the BatchNorm running statistics towards
        this batch's (training forwards that keep their updates).
        ``remat_blocks``: recompute each block and the tail in the
        backward."""
        for block in (self.head, *self.blocks):
            x = remat(block, x, train, enabled=remat_blocks,
                      update_stats=update_stats)
        return remat(self.tail, x, enabled=remat_blocks)


class Decoder(_ConvStack):
    """VAE decoder conv stack (networks_3d.py:337-341): latent_dim in."""

    def __init__(self, latent_dim: int, nfc: int, nc_im: int, ker_size: int,
                 padd_size: int, num_layer: int, ndim: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(latent_dim, nfc, nc_im, ker_size, padd_size,
                         num_layer, ndim, dtype=dtype)


class Stage(_ConvStack):
    """One refinement body stage, image to image (networks_3d.py:352-363).
    With ``pconv`` its 64 -> 64 block convs run on the K1 kernel."""

    def __init__(self, nfc: int, nc_im: int, ker_size: int, padd_size: int,
                 num_layer: int, ndim: int = 2, pconv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(nc_im, nfc, nc_im, ker_size, padd_size, num_layer,
                         ndim, pconv, dtype)


class WDiscriminator(nn.Module):
    """Patch WGAN critic: SN head 3 -> nfc, ``num_layer`` SN body convs,
    linear tail nfc -> 1; a per-patch score map with no pooling
    (``hpvaegan_tpu/models/networks.py:228-286``, networks_3d.py:163-181).
    The tail's padding is hard-coded to 1 whatever ``ker_size`` is: a
    reference quirk, kept.

    Kernel routes: under ``pfuse`` consecutive body pairs of K2's geometry
    run fused on K2 (``ops/kernels/conv3d_fuse.py``) from the pair's
    ``SNConv.normalized`` weights, on the input cast to the compute dtype
    (``networks.py:276``), keeping each block's own variables;
    an odd trailing block, and every body block without ``pfuse``, runs
    on K1 under ``pconv``.  ``forward(x, fuse=False)`` runs every body
    conv of K1's geometry on K1 and none on K2: K2's gradient is first
    order only, while K1 differentiates any number of times, so this is
    the route the trainer's WGAN-GP takes on a K1 critic (its double
    backward; ``train/steps._penalty_critic``).
    ``forward(x, use_kernels=False)`` runs the same weights on stock
    convs only: the counterpart of the JAX package's
    ``D.clone(pconv=False, pfuse=False)``, which the JAX package's
    WGAN-GP uses (``train/steps.py:316-323``; on a TPU its kernel route
    measured slower).  Under a ``mesh`` the K1 body convs run K4; K2 has
    no mesh partitioning (as in the JAX package), so a fused critic
    under a mesh raises (``--spmd`` turns ``--pfuse`` off,
    ``core/config.py``)."""

    mesh = None

    def __init__(self, nc_im: int, nfc: int, ker_size: int, num_layer: int,
                 ndim: int = 2, pconv: bool = False, pfuse: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pad = ker_size // 2
        self.num_layer, self.dtype = num_layer, dtype
        self.head = SNConv(nc_im, nfc, ker_size, pad, ndim, dtype=dtype)
        self.body = nn.ModuleList(
            SNConv(nfc, nfc, ker_size, pad, ndim, pconv=pconv, dtype=dtype)
            for _ in range(num_layer))
        self.tail = ConvND(nfc, 1, ker_size, 1, ndim, dtype=dtype)
        self.pfuse = pfuse and k1_geometry(ndim, ker_size, 1, pad, nfc,
                                           nfc)

    def reset_parameters(self, generator=None):
        _reset((self.head, *self.body, self.tail), generator)

    def sn_convs(self):
        return [self.head, *self.body]

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                update_stats: bool = False, remat=False,
                fuse: bool = True) -> torch.Tensor:
        """``update_stats`` is the baselines critic's; this critic has no
        normalisation state.  ``remat``: False, True or ``"blocks"``
        (``models/remat.py``).  ``fuse`` False: no body pair on K2."""
        return _remat_forward(self, x, use_kernels, None, remat, fuse=fuse)

    def _forward(self, x: torch.Tensor, use_kernels: bool, blocks: bool,
                 fuse: bool = True) -> torch.Tensor:
        fuse = use_kernels and fuse and self.pfuse
        if fuse and self.mesh is not None:
            raise ValueError("the fused critic pair (K2) has no mesh "
                             "partitioning: build the critic without pfuse")
        x = remat(self.head, x, use_kernels, enabled=blocks)
        i = 0
        while i < self.num_layer:
            if fuse and i + 1 < self.num_layer:
                w1, b1 = self.body[i].normalized()
                w2, b2 = self.body[i + 1].normalized()
                y = conv3d64_pair(_to_nthwc(_cast(x, self.dtype)),
                                  to_thwio(w1), b1, to_thwio(w2), b2)
                x = y.permute(0, 4, 1, 2, 3)
                i += 2
            else:
                x = remat(self.body[i], x, use_kernels, enabled=blocks)
                i += 1
        return remat(self.tail, x, enabled=blocks)


def _remat_forward(D, x, use_kernels: bool, update_stats, level, **kw):
    """A critic's forward, recomputed whole in the backward under
    ``level`` (True or ``"blocks"``), and each block too under
    ``"blocks"`` (JAX ``apply_disc``, ``train/steps.py:43-80``);
    ``update_stats`` None: the critic has no BatchNorm.  ``kw`` goes to
    ``D._forward``."""
    return remat(D._forward, x, use_kernels, level == "blocks",
                 enabled=level, update_stats=update_stats, **kw)


def pad_spatial(x: torch.Tensor, p: int, mesh=None) -> torch.Tensor:
    """Zero-pad every spatial axis of an NCDHW / NCHW tensor by ``p`` on
    both sides (the JAX package's ``_pad_spatial``), keeping its memory
    format.  Under a ``mesh`` with a spatial axis ``x`` is this rank's H
    block and so is the result, of the padded H: the zero rows fall in
    the end blocks (the whole is gathered, padded and sliced,
    ``Mesh.gather_h``/``slice_h``)."""
    if p == 0:
        return x
    if mesh is not None and mesh.n_spatial > 1:
        h_dim = x.dim() - 2
        return mesh.slice_h(pad_spatial(mesh.gather_h(x, h_dim), p), h_dim)
    y = F.pad(x, (p,) * (2 * (x.dim() - 2)))
    fmt = (torch.channels_last_3d if x.dim() == 5 else torch.channels_last)
    return y.contiguous(memory_format=fmt) if x.is_contiguous(
        memory_format=fmt) else y


class WDiscriminatorBaselines(nn.Module):
    """The baselines' critic (networks_3d.py:184-210): the input
    zero-padded by ``num_layer + 2`` on every spatial side, a head
    ``ConvBlock`` without norm, ``num_layer`` conv -> BatchNorm -> LeakyReLU
    blocks and a linear tail, all convs with ``padd_size`` and the
    N(0, 0.02) init.  No spectral norm and no kernel route, as in the JAX
    package.  BatchNorm in train mode uses the batch's statistics; the
    forward moves the running ones only when asked (``update_stats``), as
    the step's critic forwards on the real and the fake batch do and its
    gradient penalty's does not (``steps.py:534-541``).  Under a ``mesh``
    the padding is the whole H's (``pad_spatial``) and every conv takes
    its halo."""

    mesh = None

    def __init__(self, nc_im: int, nfc: int, ker_size: int, padd_size: int,
                 num_layer: int, ndim: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pad, self.dtype = num_layer + 2, dtype
        self.head = ConvBlock(nc_im, nfc, ker_size, padd_size, ndim,
                              dtype=dtype, use_norm=False, init_mode="n002")
        self.body = nn.ModuleList(
            ConvBlock(nfc, nfc, ker_size, padd_size, ndim, dtype=dtype,
                      init_mode="n002") for _ in range(num_layer))
        self.tail = ConvND(nfc, 1, ker_size, padd_size, ndim, dtype=dtype,
                           init_mode="n002")

    def reset_parameters(self, generator=None):
        _reset((self.head, *self.body, self.tail), generator)

    def sn_convs(self):
        return []

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                update_stats: bool = False, remat=False) -> torch.Tensor:
        """Train mode, as every caller runs it; ``use_kernels`` is the SN
        critic's, this one has no route.  ``remat`` as the SN critic's."""
        return _remat_forward(self, x, use_kernels, update_stats, remat)

    def _forward(self, x: torch.Tensor, use_kernels: bool, blocks: bool,
                 update_stats: bool = False) -> torch.Tensor:
        x = remat(self.head, pad_spatial(x, self.pad, self.mesh),
                  enabled=blocks)
        for block in self.body:
            x = remat(block, x, True, enabled=blocks,
                      update_stats=update_stats)
        return remat(self.tail, x, enabled=blocks)


class CSGStage(nn.Module):
    """One ConSinGAN body stage (networks_3d.py:229-234): ``num_layer``
    VALID conv -> BatchNorm -> LeakyReLU blocks of ``nfc`` channels, so it
    shrinks every spatial axis by ``2 * num_layer`` (3x3 kernels)."""

    def __init__(self, nfc: int, ker_size: int, num_layer: int,
                 ndim: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlock(nfc, nfc, ker_size, 0, ndim, dtype=dtype,
                      init_mode="n002") for _ in range(num_layer))

    def reset_parameters(self, generator=None):
        _reset(self.blocks, generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False,
                remat_blocks: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = remat(block, x, train, enabled=remat_blocks,
                      update_stats=update_stats)
        return x


class SGStage(_ConvStack):
    """One SinGAN stage (networks_3d.py:283-291): a whole sub-generator,
    head + ``num_layer`` blocks + linear tail, image to image, every conv
    VALID with the N(0, 0.02) init, so it shrinks every spatial axis by
    ``2 * (num_layer + 2)`` (3x3 kernels).  The output is raw."""

    def __init__(self, nfc: int, nc_im: int, ker_size: int, num_layer: int,
                 ndim: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__(nc_im, nfc, nc_im, ker_size, 0, num_layer, ndim,
                         dtype=dtype, init_mode="n002", tail_padding=0)
