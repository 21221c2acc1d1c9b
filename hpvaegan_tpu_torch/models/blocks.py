"""Building blocks (port of ``hpvaegan_tpu/models/blocks.py``).

Activations are NCDHW (3D) / NCHW (2D) tensors; on the card they are kept
in ``channels_last_3d`` memory format so that a conv routed to the K1
kernel sees a free NTHWC view.

Weights: a stock conv holds PyTorch's ``(O, I, *k)`` layout; a conv routed
to the K1 kernel holds THWIO ``(3, 3, 3, 64, 64)``, the kernel's layout,
so no call re-lays them out.  ``utils/convert.py`` fills both from the JAX
package's flax ``(*k, I, O)`` kernels.

BatchNorm in train mode normalises with the batch statistics and leaves
the running statistics as loaded (the JAX sampler discards its updated
``batch_stats``).  Spectral norm divides by ``sigma = u @ (W v)`` from the
stored u/v with no power iteration in the forward, as the JAX package does
(``blocks.py:261-269, 319-320``); the u/v update belongs to training.

This slice ports what ``GeneratorHPVAEGAN`` uses: zero padding, the
torch-default init, conv -> BN -> LeakyReLU blocks and LeakyReLU SN convs.
The JAX package's baseline-only options (N(0, 0.02) init, blocks without
norm, reflect padding, PReLU) come with the slices that use them.
"""
from __future__ import annotations

import math
from typing import Optional

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
    "BN_EPS",
]

_SN_EPS = 1e-12  # torch spectral_norm default
BN_EPS = 1e-5    # torch BatchNorm default (blocks.py:211-212)


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
        self.kernel_route = bool(
            pconv and ndim == 3 and ker_size == 3 and stride == 1
            and padding == 1 and in_features == 64 and features == 64)
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
            # NCDHW in channels_last_3d -> NTHWC is a view, no copy
            y = conv3d64(x.permute(0, 2, 3, 4, 1).contiguous(), self.weight,
                         self.bias)
            return y.permute(0, 4, 1, 2, 3)
        return _conv(self.ndim)(x, self.weight, self.bias, self.stride,
                                self.padding)


class _BatchNorm(nn.Module):
    """BatchNorm with torch defaults (eps 1e-5).  Train mode uses the batch
    statistics and never writes the running buffers."""

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

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=BN_EPS)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


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

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return activation(self.norm(self.conv(x), train), "lrelu")


# ---------------------------------------------------------------------------
# Spectral norm
# ---------------------------------------------------------------------------

def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _SN_EPS)


class SNConv(nn.Module):
    """Spectrally-normalized conv + LeakyReLU(0.2) (ConvBlock2DSN/3DSN with
    bn=True, networks_3d.py:59-70: no normalization layer).

    ``u`` (O,) and ``v`` (I*prod(k),) are buffers; ``v`` follows the
    flattening of ``weight.reshape(O, -1)``."""

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.ker_size, self.padding, self.ndim = ker_size, padding, ndim
        self.stride = stride
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

    def sigma(self) -> torch.Tensor:
        """u^T W v with u, v constants, differentiable w.r.t. the kernel."""
        return self.u @ (self.weight.reshape(self.features, -1) @ self.v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(self.ndim)(x, self.weight / self.sigma(), self.bias,
                             self.stride, self.padding)
        return activation(y, "lrelu")
