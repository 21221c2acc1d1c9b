"""Per-scale optimizers with per-stage learning-rate groups (port of
``hpvaegan_tpu/train/optim.py``; reference train_video.py:57-88).

The JAX package chains a global-norm clip before a grouped Adam whose
frozen groups are ``set_to_zero`` (``optim.py:214-231``).  Here:

* ``hpvaegan_group_plan`` is the same plan (``optim.py:73-107``), and
  ``baselines_group_plan`` the baselines' (``optim.py:110-131``;
  reference train_video_baselines.py:55-70): the body's last
  ``train_depth`` stages, the head while ``scale_idx < train_depth``,
  the tail always at ``lr_g``;
* ``build_g_optimizer`` is one ``torch.optim.Adam`` over the trainable
  groups only of the generator's plan (``group_plan``: the baselines'
  for ``GeneratorCSG``/``GeneratorSG``, whose trainer clips nothing),
  with ``b1 = beta1``, ``b2 = 0.999``, ``eps = 1e-8`` (optax's defaults
  and the same update rule), so frozen parameters are never touched;
* ``clip_grad_norm_`` is optax's ``clip_by_global_norm``: ``g * c / |g|``
  once ``|g| >= c``, not ``torch.nn.utils.clip_grad_norm_``'s
  ``c / (|g| + 1e-6)``.  Without ``--fast-grads`` its norm covers the
  frozen stages' gradients too, because the JAX package clips before
  ``set_to_zero`` (``steps.py:111-116``): every generator parameter keeps
  ``requires_grad`` and a ``None`` gradient counts as zero.

``--fast-grads`` waits for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

__all__ = ["hpvaegan_group_plan", "baselines_group_plan", "group_plan",
           "build_g_optimizer", "build_d_optimizer",
           "clip_grad_norm_", "ADAM_B2", "ADAM_EPS"]

ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def hpvaegan_group_plan(
        cfg, scale_idx: int, n_body: int
) -> Tuple[Dict[str, str], List[str], Dict[str, float]]:
    """LR-group plan for the HP-VAE-GAN trainers (train_video.py:57-88).

    Returns (labels of encode/decoder, body stage labels, lr table)."""
    body = ["frozen"] * n_body
    lrs: Dict[str, float] = {}

    def assign_tail(depth: int) -> None:
        depth = min(depth, n_body)
        for j, idx in enumerate(range(n_body - depth, n_body)):
            body[idx] = f"b{j}"
            lrs[f"b{j}"] = cfg.lr_g * (cfg.lr_scale ** (depth - 1 - j))

    enc = "frozen"
    if not cfg.train_all:
        if cfg.vae_levels < scale_idx + 1:
            # GAN phase: only the last train_depth' stages
            train_depth = min(cfg.train_depth, n_body - cfg.vae_levels + 1)
            assign_tail(train_depth)
        else:
            # VAE phase: encoder+decoder + last train_depth stages
            enc = "enc"
            lrs["enc"] = cfg.lr_g * (cfg.lr_scale ** scale_idx)
            assign_tail(cfg.train_depth)
    else:
        if n_body < cfg.train_depth:
            enc = "enc"
            lrs["enc"] = cfg.lr_g * (cfg.lr_scale ** scale_idx)
            assign_tail(n_body)
        else:
            assign_tail(cfg.train_depth)

    return {"encode": enc, "decoder": enc}, body, lrs


def baselines_group_plan(
        cfg, scale_idx: int, n_body: int, has_head: bool
) -> Tuple[Dict[str, str], List[str], Dict[str, float]]:
    """LR-group plan for the SinGAN/ConSinGAN baselines
    (train_video_baselines.py:55-70): body[:-train_depth] frozen, head only
    while scale_idx-train_depth<0, tail always at lr_g."""
    body = ["frozen"] * n_body
    lrs: Dict[str, float] = {}
    depth = min(cfg.train_depth, n_body)
    for j, idx in enumerate(range(n_body - depth, n_body)):
        body[idx] = f"b{j}"
        lrs[f"b{j}"] = cfg.lr_g * (cfg.lr_scale ** (depth - 1 - j))

    modules: Dict[str, str] = {}
    if has_head:
        if scale_idx - cfg.train_depth < 0:
            modules["head"] = "head"
            lrs["head"] = cfg.lr_g * (cfg.lr_scale ** scale_idx)
        else:
            modules["head"] = "frozen"
        modules["tail"] = "tail"
        lrs["tail"] = cfg.lr_g
    return modules, body, lrs


def group_plan(cfg, G, scale_idx: int):
    """The plan of ``G``'s family: the baselines' or the HP-VAE-GAN's."""
    if G.returns_triple:
        return hpvaegan_group_plan(cfg, scale_idx, len(G.body))
    return baselines_group_plan(cfg, scale_idx, len(G.body),
                                G.has_head_tail)


def _generator_groups(G, module_labels: Dict[str, str],
                      body_labels: List[str]) -> Dict[str, list]:
    """The generator's parameters by group label (``"frozen"`` included)."""
    groups: Dict[str, list] = {}
    for name, label in module_labels.items():
        groups.setdefault(label, []).extend(getattr(G, name).parameters())
    for stage, label in zip(G.body, body_labels):
        groups.setdefault(label, []).extend(stage.parameters())
    return groups


def build_g_optimizer(cfg, G, scale_idx: int) -> torch.optim.Adam:
    """Fresh per-scale generator Adam over the plan's trainable groups."""
    module_labels, body_labels, lrs = group_plan(cfg, G, scale_idx)
    groups = _generator_groups(G, module_labels, body_labels)
    return torch.optim.Adam(
        [{"params": groups[label], "lr": lr} for label, lr in lrs.items()],
        lr=cfg.lr_g, betas=(cfg.beta1, ADAM_B2), eps=ADAM_EPS)


def build_d_optimizer(cfg, D) -> torch.optim.Adam:
    return torch.optim.Adam(D.parameters(), lr=cfg.lr_d,
                            betas=(cfg.beta1, ADAM_B2), eps=ADAM_EPS)


@torch.no_grad()
def clip_grad_norm_(params: Iterable[torch.Tensor], max_norm: float
                    ) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on ``p.grad``; returns the
    global norm.  ``None`` gradients count as zero."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
