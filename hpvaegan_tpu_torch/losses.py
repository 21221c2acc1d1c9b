"""Losses and GAN math (port of ``hpvaegan_tpu/losses/__init__.py:23-82``;
reference: modules/losses.py, modules/utils.py).

The WGAN-GP's double backprop is ``torch.autograd.grad`` with
``create_graph=True``, as in the reference.  The critic it differentiates
must be made of stock ops: the kernels' gradients are first order only.
``chunked`` (``--gp-chunked``) waits for ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["kl_criterion", "kl_bern_criterion", "mse",
           "calc_gradient_penalty"]


def kl_criterion(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0,1)), mean over all elements (modules/losses.py:7-9)."""
    kld = -0.5 * (1 + logvar - mu.square() - logvar.exp())
    return kld.mean()


def kl_bern_criterion(x: torch.Tensor) -> torch.Tensor:
    """Bernoulli KL against p = 0.5 (modules/losses.py:12-14)."""
    log_half = math.log(0.5)
    kld = x * (torch.log(x + 1e-20) - log_half) + (1 - x) * (
        torch.log(1 - x + 1e-20) - log_half)
    return kld.mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.nn.MSELoss(): the mean squared error."""
    return (a - b).square().mean()


def calc_gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                          real: torch.Tensor, fake: torch.Tensor,
                          lambda_grad: float,
                          alpha: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """WGAN-GP (modules/utils.py:4-19) with the reference's quirks:

    * one scalar alpha ~ U(0, 1) for the whole batch (modules/utils.py:5-7);
      ``alpha`` hands it in, else it is drawn from ``generator``;
    * the gradient's 2-norm over the CHANNEL axis only
      (``gradients.norm(2, dim=1)``, modules/utils.py:18).  ``real`` and
      ``fake`` are in the model layout (NCDHW / NCHW), so that is dim 1 as
      in the reference.

    ``d_apply`` is the critic forward; the penalty is differentiable in
    its parameters (double backprop)."""
    if alpha is None:
        alpha = torch.rand((), generator=generator, device=real.device)
    alpha = torch.as_tensor(alpha, dtype=real.dtype, device=real.device)
    interpolates = (alpha * real + (1.0 - alpha) * fake).detach()
    interpolates.requires_grad_(True)
    out = d_apply(interpolates)
    (grads,) = torch.autograd.grad(out.sum(), interpolates,
                                   create_graph=True)
    grad_norm = grads.square().sum(dim=1).sqrt()
    return (grad_norm - 1.0).square().mean() * lambda_grad
