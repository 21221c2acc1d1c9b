"""HP-VAE-GAN in plain PyTorch: the generator and the spectrally normalised
patch critic of lior1990/hp-vae-gan (models/networks_3d.py,
networks_2d.py; arXiv 2006.12226), 2D or 3D, f32, stock convolutions only.

Module and parameter names are those of the measured package's
checkpoints (``encode.features.conv_blocks.0.weight``, ``body.8.blocks.2.
norm.running_var``, ...), and every conv weight is in torch's
``(out, in, *kernel)`` layout, so a state dict of these modules loads into
the package and a ``netG`` file written from them is one it reads.

Semantics kept (and the reference repository's quirks with them):

* a ``ConvBlock`` is conv -> BatchNorm on the batch's statistics (eps
  1e-5, biased variance) -> LeakyReLU(0.2); the running statistics are
  never read, since every forward is in train mode;
* a spectrally normalised conv divides its kernel by ``sigma = u^T W v``
  from the stored ``u``/``v``, with no power iteration in the forward;
  ``spectral_update`` advances ``u``/``v`` once (``v = n(W^T u)``, then
  ``u = n(W v)``); the encoder's blocks and the critic's head and body are
  such convs, each followed by LeakyReLU(0.2);
* the critic's tail has padding 1 whatever the kernel size;
* each refinement stage reads the previous output resized to its level
  (trilinear or bilinear, ``align_corners=True``), plus N(0, 1) noise
  times the level's amplitude in rand mode where the stage takes noise
  (3D: the stages at or above ``vae_levels``; 2D: every stage), and
  returns ``tanh(stage(x) + x_up)``; the input of stage ``vae_levels - 1``
  is cut from the gradient;
* rec mode encodes the zero-level clip, ``z = eps * exp(logvar / 2) +
  mu``, and injects no noise.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Generator", "Critic", "SNConv", "resize"]

_SN_EPS = 1e-12
_BN_EPS = 1e-5
_SLOPE = 0.2


def _conv(x, w, b, pad):
    return (F.conv3d if x.dim() == 5 else F.conv2d)(x, w, b, 1, pad)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    mode = "trilinear" if x.dim() == 5 else "bilinear"
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=True)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, pad: int, ndim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * ndim))
        self.bias = nn.Parameter(torch.empty(cout))
        self.pad = pad

    def forward(self, x):
        return _conv(x, self.weight, self.bias, self.pad)


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=_BN_EPS)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, pad: int, ndim: int):
        super().__init__()
        self.conv = Conv(cin, cout, k, pad, ndim)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), _SLOPE)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _SN_EPS)


class SNConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, pad: int, ndim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * ndim))
        self.bias = nn.Parameter(torch.empty(cout))
        self.register_buffer("u", torch.empty(cout))
        self.register_buffer("v", torch.empty(cin * k ** ndim))
        self.pad = pad

    @torch.no_grad()
    def spectral_update(self) -> None:
        w = self.weight.reshape(self.weight.shape[0], -1)
        self.v.copy_(_unit(w.T @ self.u))
        self.u.copy_(_unit(w @ self.v))

    def forward(self, x):
        w = self.weight
        sigma = self.u @ (w.reshape(w.shape[0], -1) @ self.v)
        return F.leaky_relu(_conv(x, w / sigma, self.bias, self.pad), _SLOPE)


class FeatureExtractor(nn.Module):
    def __init__(self, cin, nfc, k, pad, blocks, ndim):
        super().__init__()
        ins = [cin] + [nfc] * blocks
        self.conv_blocks = nn.ModuleList(
            SNConv(ins[i], nfc, k, pad, ndim) for i in range(blocks + 1))

    def forward(self, x):
        for block in self.conv_blocks:
            x = block(x)
        return x


class EncodeVAE(nn.Module):
    def __init__(self, cin, latent, nfc, k, blocks, ndim):
        super().__init__()
        pad = k // 2
        self.features = FeatureExtractor(cin, nfc, k, pad, blocks, ndim)
        self.mu = Conv(nfc, latent, k, pad, ndim)
        self.logvar = Conv(nfc, latent, k, pad, ndim)

    def forward(self, x):
        f = self.features(x)
        return self.mu(f), self.logvar(f)


class ConvStack(nn.Module):
    """head ConvBlock, ``num_layer`` ConvBlocks, linear tail conv."""

    def __init__(self, cin, nfc, cout, k, pad, num_layer, ndim):
        super().__init__()
        self.head = ConvBlock(cin, nfc, k, pad, ndim)
        self.blocks = nn.ModuleList(ConvBlock(nfc, nfc, k, pad, ndim)
                                    for _ in range(num_layer))
        self.tail = Conv(nfc, cout, k, k // 2, ndim)

    def forward(self, x):
        x = self.head(x)
        for block in self.blocks:
            x = block(x)
        return self.tail(x)


class Generator(nn.Module):
    """``GeneratorHPVAEGAN`` with ``stages`` refinement stages; ``shapes``
    are the spatial (or spatio-temporal) sizes of levels ``0 ..
    stages``."""

    def __init__(self, cfg: dict, ndim: int, shapes: Sequence, stages: int):
        super().__init__()
        k, pad, nfc = cfg["ker_size"], cfg["padd_size"], cfg["nfc"]
        nc, latent = cfg["nc_im"], cfg["latent_dim"]
        self.ndim = ndim
        self.shapes = [tuple(s) for s in shapes]
        self.vae_levels = cfg["vae_levels"]
        self.train_all = bool(cfg.get("train_all", False))
        self.encode = EncodeVAE(nc, latent, nfc, k, cfg["enc_blocks"], ndim)
        self.decoder = ConvStack(latent, nfc, nc, k, pad, cfg["num_layer"],
                                 ndim)
        self.body = nn.ModuleList(
            ConvStack(nc, nfc, nc, k, pad, cfg["num_layer"], ndim)
            for _ in range(stages))

    def has_noise(self, idx: int) -> bool:
        """Does stage ``idx`` take noise in rand mode?"""
        return self.ndim == 2 or self.vae_levels <= idx + 1

    def sn_convs(self) -> List[SNConv]:
        return list(self.encode.features.conv_blocks)

    def refine(self, x, amps, noises: Optional[Sequence] = None):
        """The stages on the decoder's output ``x``; ``noises[idx]`` (model
        layout) where stage ``idx`` takes noise, None in rec mode."""
        for idx, stage in enumerate(self.body):
            if self.vae_levels == idx + 1 and not self.train_all:
                x = x.detach()
            x_up = resize(x, self.shapes[idx + 1])
            x_in = x_up
            if noises is not None and self.has_noise(idx):
                x_in = x_up + noises[idx] * amps[idx + 1]
            x = torch.tanh(stage(x_in) + x_up)
        return x

    def rand(self, amps, noise_init, noises):
        """Rand mode from the decoder latent ``noise_init``."""
        return self.refine(torch.tanh(self.decoder(noise_init)), amps, noises)

    def rec(self, amps, real_zero, eps):
        """Rec mode: ``real_zero`` encoded, reparameterised with ``eps``."""
        mu, logvar = self.encode(real_zero)
        z = eps * torch.exp(0.5 * logvar) + mu
        return self.refine(torch.tanh(self.decoder(z)), amps)


class Critic(nn.Module):
    """The WGAN critic: SN head, ``num_layer`` SN body convs, linear tail
    (padding 1), a score per patch."""

    def __init__(self, cfg: dict, ndim: int):
        super().__init__()
        k, nfc, nc = cfg["ker_size"], cfg["nfc"], cfg["nc_im"]
        pad = k // 2
        self.head = SNConv(nc, nfc, k, pad, ndim)
        self.body = nn.ModuleList(SNConv(nfc, nfc, k, pad, ndim)
                                  for _ in range(cfg["num_layer"]))
        self.tail = Conv(nfc, 1, k, 1, ndim)

    def sn_convs(self) -> List[SNConv]:
        return [self.head, *self.body]

    def forward(self, x):
        x = self.head(x)
        for block in self.body:
            x = block(x)
        return self.tail(x)
