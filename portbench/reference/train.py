"""The steps of one GAN scale of HP-VAE-GAN in plain PyTorch, for the
benchmark's comparison: the noise-amplitude calibration, then the critic
step with the WGAN-GP and the generator step against the updated critic
(lior1990/hp-vae-gan train_video.py:131-200), with the draws the measured
trainer makes for the same seed: the scale's first steps from its start
(``follow``), or a later run of steps from a given state (``resume``).

The draws: iteration ``it`` of scale ``s`` draws from a
``torch.Generator`` on the device seeded ``seed_value(seed, s, it)``, in
this order: the decoder latent (N, *level-0 size, latent), the stage
noises (N, *level size, 3) of the stages that take noise, the penalty's
alpha (one U(0, 1) scalar), the reparameterisation draw (N, latent,
*level-0 size); the calibration draws its reparameterisation from
``seed_value(seed, s)``.  Channels-last draws are moved to the model
layout here.

What the measured program's optimizers are: Adam (beta2 0.999, eps 1e-8)
over the critic, and over the generator's trained stages (the last
``train_depth`` of the body, the ``i``-th from the top at ``lr_g *
lr_scale ** i``), after a global-norm clip of every generator gradient
to ``grad_clip`` (``g * c / |g|`` once ``|g| >= c``).  The critic is
frozen in the generator step."""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from .model import Critic, Generator

__all__ = ["seed_value", "iteration_draws", "calibrate", "gan_step",
           "follow", "resume", "model_state", "trained_leaves", "LOSS_TERMS"]

# a step's losses, in this order: the generator's total, its rec and
# adversarial terms, the critic's three terms
LOSS_TERMS = ("loss", "rec_loss", "errG", "errD_real", "errD_fake",
              "gradient_penalty")


def seed_value(seed: int, *key: int) -> int:
    state = np.random.SeedSequence(entropy=int(seed),
                                   spawn_key=tuple(int(k) for k in key))
    return int(state.generate_state(1, np.uint64)[0])


def _generator(dev, seed: int, *key: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed_value(seed, *key))


def _model_layout(t: torch.Tensor) -> torch.Tensor:
    return t.movedim(-1, 1)


def iteration_draws(G: Generator, cfg: dict, dev, seed: int, scale: int,
                    it: int, batch: int) -> dict:
    g = _generator(dev, seed, scale, it)
    latent, nc = cfg["latent_dim"], cfg["nc_im"]
    z = torch.randn((batch, *G.shapes[0], latent), generator=g, device=dev)
    noises = [_model_layout(torch.randn((batch, *G.shapes[i + 1], nc),
                                        generator=g, device=dev))
              if G.has_noise(i) else None for i in range(len(G.body))]
    alpha = torch.rand((), generator=g, device=dev)
    eps = torch.randn((batch, latent, *G.shapes[0]), generator=g,
                      device=dev)
    return {"noise_init": _model_layout(z), "noises": noises,
            "alpha": alpha, "eps": eps}


def half_batch(d: dict) -> dict:
    """The draws of the first sample alone (the fault of a step that
    leaves half of its batch out)."""
    return {"noise_init": d["noise_init"][:1],
            "noises": [None if n is None else n[:1] for n in d["noises"]],
            "alpha": d["alpha"], "eps": d["eps"][:1]}


@torch.no_grad()
def calibrate(G: Generator, cfg: dict, real, real_zero, amps, dev,
              seed: int, scale: int) -> float:
    """The scale's noise amplitude: ``noise_amp * rmse / batch`` of a rec
    forward (train_video.py:131-145)."""
    g = _generator(dev, seed, scale)
    eps = torch.randn((real.shape[0], cfg["latent_dim"], *G.shapes[0]),
                      generator=g, device=dev)
    out = G.rec(amps, real_zero, eps)
    rmse = float((out - real).square().mean().sqrt())
    return cfg["noise_amp"] * rmse / cfg["batch_size"]


def trained_leaves(G: Generator, cfg: dict) -> Dict[str, float]:
    """{name: learning rate} of the generator's trained leaves in the GAN
    phase (the last ``train_depth`` stages)."""
    n = len(G.body)
    depth = min(cfg["train_depth"], n - cfg["vae_levels"] + 1, n)
    out = {}
    for j, idx in enumerate(range(n - depth, n)):
        lr = cfg["lr_g"] * cfg["lr_scale"] ** (depth - 1 - j)
        for name, _ in G.body[idx].named_parameters():
            out[f"body.{idx}.{name}"] = lr
    return out


def _adam(groups, cfg) -> torch.optim.Adam:
    return torch.optim.Adam(groups, betas=(cfg["beta1"], 0.999), eps=1e-8,
                            foreach=False)


@torch.no_grad()
def _clip(params, max_norm: float) -> None:
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _penalty(D: Critic, real, fake, alpha, lam: float) -> torch.Tensor:
    x = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(D(x).sum(), x, create_graph=True)
    return (grads.square().sum(dim=1).sqrt() - 1.0).square().mean() * lam


def gan_step(G: Generator, D: Critic, cfg: dict, real, real_zero, d: dict,
             amps, opt_g=None, opt_d=None, grads: Optional[dict] = None
             ) -> Dict[str, torch.Tensor]:
    """One GAN step on model-layout ``real``/``real_zero`` with the draws
    ``d``.  ``grads``: filled with ``{parameter: gradient}`` as each
    optimizer gets it.  Without optimizers the step updates nothing (the
    operation count)."""
    for m in G.sn_convs() + D.sn_convs():
        m.spectral_update()
    with torch.no_grad():
        fake = G.rand(amps, d["noise_init"], d["noises"])
    nb = real.shape[0]
    D.zero_grad(set_to_none=True)
    out = D(torch.cat([real, fake]))
    errD_real, errD_fake = -out[:nb].mean(), out[nb:].mean()
    gp = _penalty(D, real, fake, d["alpha"], cfg["lambda_grad"])
    (errD_real + errD_fake + gp).backward()
    if grads is not None:
        grads.update({p: p.grad.detach().clone() for p in D.parameters()})
    if opt_d is not None:
        opt_d.step()
    D.requires_grad_(False)
    try:
        G.zero_grad(set_to_none=True)
        generated = G.rec(amps, real_zero, d["eps"])
        fake_g = G.rand(amps, d["noise_init"], d["noises"])
        rec = (generated - real).square().mean()
        errG = -D(fake_g).mean() * cfg["disc_loss_weight"]
        total = cfg["rec_weight"] * rec + errG
        total.backward()
    finally:
        D.requires_grad_(True)
    if opt_g is not None:
        _clip(list(G.parameters()), cfg["grad_clip"])
        if grads is not None:
            grads.update({p: p.grad.detach().clone()
                          for g in opt_g.param_groups for p in g["params"]})
        opt_g.step()
    return {"loss": total.detach(), "rec_loss": rec.detach(),
            "errG": errG.detach(), "errD_real": errD_real.detach(),
            "errD_fake": errD_fake.detach(), "gradient_penalty": gp.detach()}


def _optimizers(G: Generator, D: Critic, cfg: dict):
    """The two Adams as the measured trainer builds them, and ``{leaf
    name: parameter}`` of the leaves they train (the critic's under
    ``D.``)."""
    lrs = trained_leaves(G, cfg)
    gparams = dict(G.named_parameters())
    by_lr: Dict[float, list] = {}
    for name, lr in lrs.items():
        by_lr.setdefault(lr, []).append(gparams[name])
    opt_g = _adam([{"params": ps, "lr": lr} for lr, ps in by_lr.items()],
                  cfg)
    opt_d = _adam([{"params": list(D.parameters()), "lr": cfg["lr_d"]}],
                  cfg)
    leaves = {name: gparams[name] for name in lrs}
    leaves.update({f"D.{n}": p for n, p in D.named_parameters()})
    return opt_g, opt_d, leaves


def model_state(G: Generator, D: Critic) -> Dict[str, torch.Tensor]:
    """The generator's and the critic's state dicts in one, the critic's
    keys under ``D.``."""
    out = dict(G.state_dict())
    out.update({f"D.{k}": v for k, v in D.state_dict().items()})
    return out


def _steps(G, D, cfg, real, real_zero, amps, opt_g, opt_d, leaves, dev,
           seed: int, scale: int, start: int, steps: int,
           fault: Optional[str]) -> dict:
    """Iterations ``start .. start + steps - 1``: their losses, the first
    one's gradient norms and each leaf's change over them."""
    batch = real.shape[0]
    init = {n: p.detach().clone() for n, p in leaves.items()}
    losses, first = [], {}
    for it in range(start, start + steps):
        d = iteration_draws(G, cfg, dev, seed, scale, it, batch)
        r, rz = real, real_zero
        if fault == "half_batch":
            d, r, rz = half_batch(d), real[:1], real_zero[:1]
        grads = {} if it == start else None
        m = gan_step(G, D, cfg, r, rz, d, amps, opt_g, opt_d, grads)
        if it == start:
            first = {n: float(torch.linalg.vector_norm(grads[p]))
                     for n, p in leaves.items()}
        losses.append(tuple(float(m[k]) for k in LOSS_TERMS))
    change = {n: float(torch.linalg.vector_norm(p.detach() - init[n]))
              for n, p in leaves.items()}
    return {"losses": losses, "grads": first, "change": change}


def follow(G0: Generator, D0: Critic, cfg: dict, real, real_zero,
           amps_before: List[float], dev, seed: int, scale: int,
           steps: int, fault: Optional[str] = None) -> dict:
    """Calibrate and take ``steps`` GAN steps on copies of ``G0``/``D0``;
    returns ``{"amp", "losses": [LOSS_TERMS a step], "grads": {leaf:
    norm of the first step's gradient}, "change": {leaf: norm of the
    change after the steps}, "state"}``, the leaves named as in the
    checkpoints (the critic's under ``D.``), ``state`` the one that
    ``resume`` takes, after the steps.  ``fault="half_batch"``: every
    step on the first sample alone."""
    G, D = copy.deepcopy(G0), copy.deepcopy(D0)
    amp = calibrate(G, cfg, real, real_zero, amps_before, dev, seed, scale)
    amps = torch.tensor(list(amps_before) + [amp], dtype=torch.float32,
                        device=dev)
    opt_g, opt_d, leaves = _optimizers(G, D, cfg)
    out = _steps(G, D, cfg, real, real_zero, amps, opt_g, opt_d, leaves,
                 dev, seed, scale, 0, steps, fault)
    names, adam = {id(p): n for n, p in leaves.items()}, {}
    for opt in (opt_g, opt_d):
        for p, s in opt.state.items():
            adam[names[id(p)]] = (float(s["step"]), s["exp_avg"].clone(),
                                  s["exp_avg_sq"].clone())
    state = {"model": {k: v.clone() for k, v in model_state(G, D).items()},
             "adam": adam}
    return dict(out, amp=amp, state=state)


def resume(G0: Generator, D0: Critic, cfg: dict, real, real_zero,
           amps: List[float], dev, seed: int, scale: int, state: dict,
           start: int, steps: int, fault: Optional[str] = None) -> dict:
    """Take iterations ``start .. start + steps - 1`` from ``state``, the
    one before iteration ``start``: ``{"model": {key: tensor}`` (as
    ``model_state``), ``"adam": {leaf: (step, exp_avg, exp_avg_sq)}}``,
    with every noise amplitude given (the scale's calibrated one last).
    Returns ``{"losses", "grads", "change"}`` as ``follow``'s, of these
    iterations."""
    G, D = copy.deepcopy(G0), copy.deepcopy(D0)
    model = state["model"]
    G.load_state_dict({k: model[k] for k in G.state_dict()})
    D.load_state_dict({k: model[f"D.{k}"] for k in D.state_dict()})
    opt_g, opt_d, leaves = _optimizers(G, D, cfg)
    for name, p in leaves.items():
        step, m, v = state["adam"][name]
        opt = opt_d if name.startswith("D.") else opt_g
        opt.state[p] = {"step": torch.tensor(float(step)),
                        "exp_avg": m.to(p.device, copy=True),
                        "exp_avg_sq": v.to(p.device, copy=True)}
    amps_t = torch.tensor(list(amps), dtype=torch.float32, device=dev)
    return _steps(G, D, cfg, real, real_zero, amps_t, opt_g, opt_d, leaves,
                  dev, seed, scale, start, steps, fault)
