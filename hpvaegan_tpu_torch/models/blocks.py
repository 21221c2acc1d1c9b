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

Compute dtype (``dtype``, flax's ``dtype=``; None is f32): a conv casts
its input, weight and bias to it, convolves with f32 accumulation, rounds
to it and adds the bias in it (flax ``nn.Conv``, ``blocks.py:196-205``;
the SN conv ``:350-358``).  The parameters stay f32.  BatchNorm always
runs in f32 (``dtype=jnp.float32``, ``:242-245``), so a ``ConvBlock``'s
output is f32 and the next conv casts it back.  The K1 route computes the
same function with one rounding: the bias is added in f32 inside the
kernel (``conv3d_pack.py:176``); the SN conv's route also applies its
LeakyReLU in f32 before rounding, where the JAX package applies it to
the rounded bf16 output (``blocks.py:338-345``): the two differ by at
most one bf16 ulp on negative values.

Under a mesh (``mesh``, set by ``parallel.mesh.attach``; the JAX
modules' ``mesh`` field, ``blocks.py:111-134, 151-186, 289-345``) every
block runs on this rank's block of the activation (batch over ``data``,
H over ``spatial``):

* a conv routed to K1 runs K4 (``ops/kernels/conv3d_spmd.py``): the H
  halo exchanged with the ring neighbours, K1 on the haloed block, the
  interior kept;
* a stock conv takes the same halo and runs ``F.conv3d`` on the haloed
  block with no padding along H, which gives the interior rows directly
  (how XLA partitions such a conv); stride 1 only;
* BatchNorm takes its batch statistics over the whole mesh: one
  differentiable all-reduce of the per-channel sum, sum of squares and
  count (``Mesh.all_sum``), the biased variance over the global count,
  so the running buffers move identically on every rank.

Initialisation (``init_mode``): ``"torch"``, PyTorch's default, for
every module of ``GeneratorHPVAEGAN``, ``GeneratorVAE_nb`` and the SN
critic; ``"n002"``, the baselines' ``weights_init``
(``blocks.py:69-76``, networks_3d.py:9-15): conv kernels N(0, 0.02) and
BatchNorm scales N(1, 0.02), the conv biases keeping PyTorch's default
uniform.  A ``ConvBlock`` may leave out its BatchNorm (``use_norm``), as
the baselines' critic head does.  Zero padding only: the JAX package's
reflect padding and PReLU are set by no model of the zoo.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.conv3d_pack import conv3d64, scalar_as
from ..ops.kernels.conv3d_spmd import conv3d64_spmd, halo

__all__ = [
    "torch_kernel_init",
    "torch_bias_init",
    "n002_kernel_init",
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


@torch.no_grad()
def n002_kernel_init(weight: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> None:
    """The baselines' ``weights_init``: N(0, 0.02) (networks_3d.py:9-15)."""
    weight.normal_(0.0, 0.02, generator=generator)


def _check_init_mode(init_mode: str) -> str:
    if init_mode not in ("torch", "n002"):
        raise ValueError(f"unknown init_mode {init_mode!r} (torch|n002)")
    return init_mode


# ---------------------------------------------------------------------------
# Activations (networks_3d.py:18-26)
# ---------------------------------------------------------------------------

def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "lrelu":
        # the slope in x's dtype, as flax's leaky_relu takes it
        return F.leaky_relu(x, negative_slope=scalar_as(0.2, x.dtype))
    if act == "elu":
        return F.elu(x, alpha=1.0)
    if act == "selu":
        return F.selu(x)
    raise ValueError(f"unknown activation: {act}")


def _conv(ndim: int):
    return F.conv3d if ndim == 3 else F.conv2d


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the compute dtype (None: as it is)."""
    return x if dtype is None else x.to(dtype)


def _stock_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                ndim: int, stride: int, padding: int,
                dtype: Optional[torch.dtype], mesh=None) -> torch.Tensor:
    """A stock conv in the compute dtype: f32 with the bias fused, or
    operands cast to ``dtype``, the product rounded to it and the bias
    added in it (flax's ``nn.Conv(dtype=...)``).  Under a ``mesh`` with
    a spatial axis ``x`` is this rank's H block: it takes ``padding`` rows
    of halo and no zero padding along H."""
    if mesh is not None and mesh.n_spatial > 1 and padding > 0:
        if stride != 1:
            raise NotImplementedError("a strided conv under a spatial mesh")
        h_dim = 3 if ndim == 3 else 2
        x = halo(x, mesh, h_dim, padding)
        padding = (padding, 0, padding) if ndim == 3 else (0, padding)
    if dtype is None:
        return _conv(ndim)(x, w, b, stride, padding)
    y = _conv(ndim)(x.to(dtype), w.to(dtype), None, stride, padding)
    return y + b.to(dtype).reshape(-1, *(1,) * ndim)


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
    layout; under a ``mesh`` the K1 route runs K4.  ``dtype``: the
    compute dtype (None: f32).  ``init_mode``: ``"torch"`` or
    ``"n002"`` (the kernel N(0, 0.02), the bias PyTorch's default)."""

    mesh = None

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False, dtype: Optional[torch.dtype] = None,
                 init_mode: str = "torch"):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.ker_size, self.padding, self.ndim = ker_size, padding, ndim
        self.stride, self.dtype = stride, dtype
        self.init_mode = _check_init_mode(init_mode)
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
        if self.init_mode == "n002":
            n002_kernel_init(self.weight, generator)
        else:
            torch_kernel_init(self.weight, fan_in, generator)
        torch_bias_init(fan_in)(self.bias, generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """A checkpoint written under the other route (``--pconv-all`` on
        or off) holds the other layout; it loads either way."""
        key = prefix + "weight"
        w = state_dict.get(key)
        if w is not None and w.dim() == 5 and \
                tuple(w.shape) != tuple(self.weight.shape):
            state_dict[key] = (to_thwio(w) if self.kernel_route
                               else w.permute(4, 3, 0, 1, 2))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_route:
            x = _to_nthwc(_cast(x, self.dtype))
            y = (conv3d64(x, self.weight, self.bias) if self.mesh is None
                 else conv3d64_spmd(x, self.weight, self.bias, self.mesh))
            return y.permute(0, 4, 1, 2, 3)
        return _stock_conv(x, self.weight, self.bias, self.ndim, self.stride,
                           self.padding, self.dtype, self.mesh)


class _BatchNorm(nn.Module):
    """BatchNorm with torch defaults (eps 1e-5), in f32 whatever its input
    (flax ``BatchNorm(dtype=jnp.float32)``); its scale starts at 1, or
    N(1, 0.02) under ``init_mode="n002"``.  Train mode uses the batch
    statistics; with ``update_stats`` it also moves the running buffers
    towards them as flax does: ``ra = 0.9 ra + 0.1 batch`` with the
    biased batch variance.  Under a ``mesh`` the batch statistics are
    the whole mesh's."""

    mesh = None

    def __init__(self, features: int, init_mode: str = "torch"):
        super().__init__()
        self.init_mode = _check_init_mode(init_mode)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.init_mode == "n002":   # N(1, 0.02), blocks.py:74-76
            self.weight.normal_(1.0, 0.02, generator=generator)
        else:
            self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = x.float()
        if train and self.mesh is not None:
            return self._mesh_forward(x, update_stats)
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
        self._move_running_stats(mean, var)

    @torch.no_grad()
    def _move_running_stats(self, mean: torch.Tensor,
                            var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        self.running_var.mul_(BN_MOMENTUM).add_(
            (1 - BN_MOMENTUM) * var.clamp_min(0))

    def _mesh_forward(self, x: torch.Tensor,
                      update_stats: bool) -> torch.Tensor:
        """Batch statistics over every rank's block: the per-channel sum,
        sum of squares and count in one differentiable all-reduce."""
        dims = [d for d in range(x.dim()) if d != 1]
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = self.mesh.all_sum(torch.cat([x.sum(dim=dims),
                                            (x * x).sum(dim=dims), count]))
        mean = sums[:c] / sums[-1]
        var = sums[c:2 * c] / sums[-1] - mean * mean   # biased, as flax
        if update_stats:
            self._move_running_stats(mean.detach(), var.detach())
        shape = (1, c) + (1,) * (x.dim() - 2)
        scale = (self.weight * torch.rsqrt(var + BN_EPS)).reshape(shape)
        return (x - mean.reshape(shape)) * scale + self.bias.reshape(shape)


class ConvBlock(nn.Module):
    """Conv (in ``dtype``) -> BatchNorm (f32) -> LeakyReLU(0.2)
    (networks_3d.py:48-56): the output is f32.  Without ``use_norm`` the
    LeakyReLU takes the conv's output, in the compute dtype.
    ``init_mode`` initialises the conv and the norm (see ``ConvND``)."""

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False, dtype: Optional[torch.dtype] = None,
                 use_norm: bool = True, init_mode: str = "torch"):
        super().__init__()
        self.conv = ConvND(in_features, features, ker_size, padding, ndim,
                           stride, pconv=pconv, dtype=dtype,
                           init_mode=init_mode)
        self.norm = _BatchNorm(features, init_mode) if use_norm else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.conv.reset_parameters(generator)
        if self.norm is not None:
            self.norm.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y, train, update_stats)
        return activation(y, "lrelu")


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
    ``:290-295, 322-323``).  Under a ``mesh`` the K1 route runs K4 and
    the stock route takes the H halo.  ``dtype``: the compute dtype
    (None: f32); the output has it."""

    mesh = None

    def __init__(self, in_features: int, features: int, ker_size: int,
                 padding: int, ndim: int = 2, stride: int = 1,
                 pconv: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.ker_size, self.padding, self.ndim = ker_size, padding, ndim
        self.stride, self.dtype = stride, dtype
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
            x = _to_nthwc(_cast(x, self.dtype))
            y = (conv3d64(x, to_thwio(w), b, neg_slope=0.2)
                 if self.mesh is None else
                 conv3d64_spmd(x, to_thwio(w), b, self.mesh, neg_slope=0.2))
            return y.permute(0, 4, 1, 2, 3)
        y = _stock_conv(x, w, b, self.ndim, self.stride, self.padding,
                        self.dtype, self.mesh)
        return activation(y, "lrelu")
