"""Building blocks (port of ``hpvaegan_tpu/models/blocks.py``).

Activations are NCDHW (3D) / NCHW (2D) tensors; on the card they are kept
in ``channels_last_3d`` memory format so that a conv routed to the K1
kernel sees a free NTHWC view.

Weights: a stock conv holds PyTorch's ``(O, I, *k)`` layout; a conv routed
to the K1 kernel holds THWIO ``(3, 3, 3, 64, 64)``, the kernel's layout,
so no call re-lays them out.  ``utils/convert.py`` fills both from the JAX
package's flax ``(*k, I, O)`` kernels.

BatchNorm in train mode normalises with the batch statistics.  It leaves
the running statistics as loaded unless the caller asks for an update
(``update_stats``), which follows flax's rule, not torch's: momentum 0.9
and the biased batch variance (``blocks.py:208-212, 242-245``).  Sampling
never asks (the JAX sampler discards its updated ``batch_stats``).
Spectral norm divides by ``sigma = u @ (W v)`` from the stored u/v with no
power iteration in the forward, as the JAX package does
(``blocks.py:261-269, 319-320``); ``SNConv.spectral_update`` advances u/v
once per optimisation step (``:370-399``).

This slice ports what ``GeneratorHPVAEGAN`` uses: zero padding, the
torch-default init, conv -> BN -> LeakyReLU blocks and LeakyReLU SN convs.
The JAX package's baseline-only options (N(0, 0.02) init, blocks without
norm, reflect padding, PReLU) come with the slices that use them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.conv3d_pack import conv3d64

__all__ = [
    "torch_kernel_init",
    "torch_bias_init",
    "activation",
    "ConvND",
    "ConvBlock",
    "SNConv",
    "k1_geometry",
    "to_thwio",
    "BN_EPS",
    "BN_MOMENTUM",
]

_SN_EPS = 1e-12  # torch spectral_norm default
BN_EPS = 1e-5    # torch BatchNorm default (blocks.py:211-212)
BN_MOMENTUM = 0.9  # flax's convention: ra <- 0.9 ra + 0.1 batch


# ---------------------------------------------------------------------------
# Initializers (blocks.py:49-66); ``generator`` makes them reproducible
# ---------------------------------------------------------------------------

@torch.no_grad()
def torch_kernel_init(weight: torch.Tensor, fan_in: int,
                      generator: Optional[torch.Generator] = None) -> None:
    """torch Conv default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    weight.uniform_(-bound, bound, generator=generator)


def torch_bias_init(fan_in: int):
    bound = 1.0 / math.sqrt(fan_in)

    @torch.no_grad()
    def init(bias: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> None:
        bias.uniform_(-bound, bound, generator=generator)

    return init


# ---------------------------------------------------------------------------
# Activations (networks_3d.py:18-26)
# ---------------------------------------------------------------------------

def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, negative_slope=0.2)
    if act == "elu":
        return F.elu(x, alpha=1.0)
    if act == "selu":
        return F.selu(x)
    raise ValueError(f"unknown activation: {act}")


def _conv(ndim: int):
    return F.conv3d if ndim == 3 else F.conv2d


def k1_geometry(ndim: int, ker_size: int, stride: int, padding: int,
                in_features: int, features: int) -> bool:
    """The K1 kernel's routing gate: a 3D, 3x3x3, stride-1, zero-padded
    SAME conv with 64 -> 64 channels (``blocks.py:164-166``; the TPU-only
    gates are dropped, see ``ops/kernels/conv3d_pack.py``)."""
    return (ndim == 3 and ker_size == 3 and stride == 1 and padding == 1
            and in_features == 64 and features == 64)


def _to_nthwc(x: torch.Tensor) -> torch.Tensor:
    """NCDHW in channels_last_3d -> NTHWC is a view, no copy."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def to_thwio(weight: torch.Tensor) -> torch.Tensor:
    """A torch ``(O, I, 3, 3, 3)`` kernel as the kernels' THWIO layout
    (a differentiable copy)."""
    return weight.permute(2, 3, 4, 1, 0).contiguous()


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

class ConvND(nn.Module):
    """Plain N-D conv with symmetric zero padding.

    With ``pconv`` a conv that is 3D, 3x3x3, stride 1, padding 1 and
    64 -> 64 runs on the K1 kernel (``ops/kernels/conv3d_pack.py``): the
    route of ``blocks.py:164-186`` without its TPU-only gates.  The route
    is fixed at construction (``kernel_route``) and decides the weight
    layout."""

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.ker_size, self.padding, self.ndim = ker_size, padding, ndim
        self.stride = stride
        self.kernel_route = pconv and k1_geometry(
            ndim, ker_size, stride, padding, in_features, features)
        k = (ker_size,) * ndim
        shape = ((*k, in_features, features) if self.kernel_route
                 else (features, in_features, *k))
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.ker_size ** self.ndim * self.in_features
        torch_kernel_init(self.weight, fan_in, generator)
        torch_bias_init(fan_in)(self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_route:
            y = conv3d64(_to_nthwc(x), self.weight, self.bias)
            return y.permute(0, 4, 1, 2, 3)
        return _conv(self.ndim)(x, self.weight, self.bias, self.stride,
                                self.padding)


class _BatchNorm(nn.Module):
    """BatchNorm with torch defaults (eps 1e-5).  Train mode uses the batch
    statistics; with ``update_stats`` it also moves the running buffers
    towards them as flax does: ``ra = 0.9 ra + 0.1 batch`` with the
    biased batch variance."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        if train:
            if update_stats:
                self._update_running_stats(x)
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=BN_EPS)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)

    @torch.no_grad()
    def _update_running_stats(self, x: torch.Tensor) -> None:
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean  # biased, as flax
        self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        self.running_var.mul_(BN_MOMENTUM).add_(
            (1 - BN_MOMENTUM) * var.clamp_min(0))


class ConvBlock(nn.Module):
    """Conv -> BatchNorm -> LeakyReLU(0.2) (networks_3d.py:48-56)."""

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False):
        super().__init__()
        self.conv = ConvND(in_features, features, ker_size, padding, ndim,
                           stride, pconv=pconv)
        self.norm = _BatchNorm(features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.conv.reset_parameters(generator)
        self.norm.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        return activation(self.norm(self.conv(x), train, update_stats),
                          "lrelu")


# ---------------------------------------------------------------------------
# Spectral norm
# ---------------------------------------------------------------------------

def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _SN_EPS)


class SNConv(nn.Module):
    """Spectrally-normalized conv + LeakyReLU(0.2) (ConvBlock2DSN/3DSN with
    bn=True, networks_3d.py:59-70: no normalization layer).

    ``u`` (O,) and ``v`` (I*prod(k),) are buffers; ``v`` follows the
    flattening of ``weight.reshape(O, -1)``.  The weight stays in torch's
    ``(O, I, *k)`` layout on every route.  With ``pconv`` a conv of K1's
    geometry runs on the K1 kernel with the THWIO view of
    ``weight / sigma`` (``blocks.py:325-345``); ``normalized`` hands the
    same pair to the fused K2 path instead (the JAX ``defer``,
    ``:290-295, 322-323``)."""

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.ker_size, self.padding, self.ndim = ker_size, padding, ndim
        self.stride = stride
        self.kernel_route = pconv and k1_geometry(
            ndim, ker_size, stride, padding, in_features, features)
        k = (ker_size,) * ndim
        self.weight = nn.Parameter(torch.empty(features, in_features, *k))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("u", torch.empty(features))
        self.register_buffer("v", torch.empty(in_features * ker_size ** ndim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.ker_size ** self.ndim * self.in_features
        torch_kernel_init(self.weight, fan_in, generator)
        torch_bias_init(fan_in)(self.bias, generator)
        u = torch.randn(self.features, generator=generator,
                        device=self.weight.device)
        self.u.copy_(_l2normalize(u))
        # v from the kernel at init (the first half of a power-iteration
        # step): an independent random v would give sigma ~ 0
        self.v.copy_(_l2normalize(self.weight.reshape(self.features, -1).T
                                  @ self.u))

    @torch.no_grad()
    def spectral_update(self) -> None:
        """One power-iteration step in place on the buffers:
        ``v <- normalize(W^T u)``, then ``u <- normalize(W v)``."""
        w = self.weight.reshape(self.features, -1)
        self.v.copy_(_l2normalize(w.T @ self.u))
        self.u.copy_(_l2normalize(w @ self.v))

    def sigma(self) -> torch.Tensor:
        """u^T W v with u, v constants, differentiable w.r.t. the kernel."""
        return self.u @ (self.weight.reshape(self.features, -1) @ self.v)

    def normalized(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(weight / sigma, bias)``, differentiable in both."""
        return self.weight / self.sigma(), self.bias

    def forward(self, x: torch.Tensor, use_kernels: bool = True
                ) -> torch.Tensor:
        w, b = self.normalized()
        if self.kernel_route and use_kernels:
            y = conv3d64(_to_nthwc(x), to_thwio(w), b, neg_slope=0.2)
            return y.permute(0, 4, 1, 2, 3)
        y = _conv(self.ndim)(x, w, b, self.stride, self.padding)
        return activation(y, "lrelu")
