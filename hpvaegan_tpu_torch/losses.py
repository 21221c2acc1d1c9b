"""Losses and GAN math (port of ``hpvaegan_tpu/losses/__init__.py:23-82``;
reference: modules/losses.py, modules/utils.py).

Dtypes follow torch's promotion, which gives the JAX package's scalars
here: ``mean`` of a bf16 critic score is bf16 (``steps.py:309-310,
362``), ``mse`` of a bf16 sample against the f32 real is f32 (``:360``),
the KL of bf16 ``mu``/``logvar`` is bf16.  The GP's interpolates are the
one place where they differ (see ``calc_gradient_penalty``).

The WGAN-GP's double backprop is ``torch.autograd.grad`` with
``create_graph=True``, as in the reference.  The critic it differentiates
may run stock convs (the JAX package's route) or the K1 kernels, whose
gradients are differentiable any number of times (the trainer's route
for a K1 critic, ``train/steps._penalty_critic``); the inner gradient
is taken w.r.t. the input alone, and K1's backward then computes no
weight gradient (``conv3d_pack._engine_runs``).  K2's gradients are
first order only.
``chunked`` (``--gp-chunked``) evaluates it one sample at a time and
backpropagates each sample's term at once, so that one sample's double
backward graph lives at a time (the JAX package's ``lax.map``).

Under a ``mesh`` (``parallel/mesh.py``) the tensors are this rank's
blocks and each mean is this rank's share of the whole mean: the sum
over its block divided by the whole tensor's count (``global_mean``).
The shares of all ranks add up to the single-process loss, so each rank
backpropagates its share and the step sums the gradients
(``train/steps.py``).  The GP's norm is over channels only, so it stays
local.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


__all__ = ["global_mean", "kl_criterion", "kl_bern_criterion", "mse",
           "calc_gradient_penalty"]


def global_mean(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t.mean()``; under a ``mesh``, this rank's share of the mean of
    the whole tensor whose block ``t`` is (in ``t``'s dtype)."""
    if mesh is None:
        return t.mean()
    return (t.float().sum() / mesh.count(t)).to(t.dtype)


def kl_criterion(mu: torch.Tensor, logvar: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """KL(q || N(0,1)), mean over all elements (modules/losses.py:7-9)."""
    kld = -0.5 * (1 + logvar - mu.square() - logvar.exp())
    return global_mean(kld, mesh)


def kl_bern_criterion(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Bernoulli KL against p = 0.5 (modules/losses.py:12-14), mean over
    all elements."""
    log_half = math.log(0.5)
    kld = x * (torch.log(x + 1e-20) - log_half) + (1 - x) * (
        torch.log(1 - x + 1e-20) - log_half)
    return global_mean(kld, mesh)


def mse(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """torch.nn.MSELoss(): the mean squared error."""
    return global_mean((a - b).square(), mesh)


def calc_gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                          real: torch.Tensor, fake: torch.Tensor,
                          lambda_grad: float,
                          alpha: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          mesh=None, chunked=False) -> torch.Tensor:
    """WGAN-GP (modules/utils.py:4-19) with the reference's quirks:

    * one scalar alpha ~ U(0, 1) for the whole batch (modules/utils.py:5-7);
      ``alpha`` hands it in, else it is drawn from ``generator``;
    * the gradient's 2-norm over the CHANNEL axis only
      (``gradients.norm(2, dim=1)``, modules/utils.py:18).  ``real`` and
      ``fake`` are in the model layout (NCDHW / NCHW), so that is dim 1 as
      in the reference.

    ``d_apply`` is the critic forward; the penalty is differentiable in
    its parameters (double backprop).  The interpolates are f32 whatever
    ``fake``'s dtype, as the JAX package's f32 alpha makes them (torch
    would keep a 0-d f32 tensor times a bf16 tensor in bf16).  Under a
    ``mesh`` ``real`` and ``fake`` are this rank's blocks and ``alpha``
    is the same on every rank: ``out.sum()`` is this rank's share of the
    whole sum, and the halo's adjoint inside ``d_apply``'s backward adds
    the neighbours' shares, so ``grads`` is the whole gradient's block.

    ``chunked`` (True, or ``"unroll"``, which differs in the JAX package
    by XLA's scheduling only): the per-sample penalties
    (``losses/__init__.py:71-82``), each backpropagated into the critic's
    parameters as soon as it is formed, so that the peak holds one
    sample's double backward; the result is detached, already in the
    gradients, and the caller backpropagates its other terms.  It equals
    the batched penalty up to the order of the sums.  Only for a critic
    whose samples do not interact (not the BatchNorm baselines critic).
    Under a ``mesh`` the loop runs over this rank's samples; each term is
    its share of the whole mean, as ``global_mean`` makes it."""
    if alpha is None:
        alpha = torch.rand((), generator=generator, device=real.device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=real.device)
    interpolates = alpha * real.float() + (1.0 - alpha) * fake.float()
    if chunked:
        count = (interpolates[:, 0].numel() if mesh is None
                 else mesh.count(interpolates[:, 0]))
        total = torch.zeros((), device=real.device)
        for i in range(interpolates.shape[0]):
            term = _penalty(d_apply, interpolates[i:i + 1]).float().sum() \
                / count * lambda_grad
            term.backward()
            total = total + term.detach()
        return total
    return global_mean(_penalty(d_apply, interpolates), mesh) * lambda_grad


def _penalty(d_apply, interpolates: torch.Tensor) -> torch.Tensor:
    """``(|grad_x D(x)|_channels - 1)^2`` at the (detached) ``x``, with
    the graph of its gradient kept for the double backprop."""
    x = interpolates.detach().requires_grad_(True)
    out = d_apply(x).sum()
    (grads,) = torch.autograd.grad(out, x, create_graph=True)
    return (grads.square().sum(dim=1).sqrt() - 1.0).square()
