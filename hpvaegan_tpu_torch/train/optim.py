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
  ``requires_grad`` and a ``None`` gradient counts as zero;
* ``--fast-grads`` (``optim.py:149-200``, ``steps.py:184-199``):
  ``freeze_frozen`` turns ``requires_grad`` off, for the scale, on every
  parameter the plan labels frozen, so autograd computes no gradient for
  them (and no input gradient ahead of the first trainable one); their
  gradients stay ``None``, so the clip's norm covers the trainable
  gradients only, the JAX package's documented deviation
  (``steps.py:119-124``).  ``hoist_index`` is the first trainable body
  stage when the hoist of ``--hoist-prefix`` applies (``steps.py:173-182``);
* on CUDA both optimizers are ``capturable`` Adams (their step count on
  the card), whatever ``--scan-steps``: a step captured in a CUDA graph
  (``train/graphs.py``) and an eager step then run one update rule;
* ``reset_adam_`` puts a used Adam back to a fresh one's state in place
  (``--compile-ahead`` warms the next scale's optimizers up on stand-in
  inputs before a CUDA graph captures their tensors);
* ``load_jax_g_state``/``load_jax_d_state`` take a JAX ``netG_mid``'s
  optax states: the generator's is ``chain(clip_by_global_norm,
  multi_transform({label: adam | set_to_zero}))`` (without the clip when
  ``grad_clip`` is None; ``optim.py:214-231``), whose per-label Adam
  ``count``/``mu``/``nu`` become ``step``/``exp_avg``/``exp_avg_sq`` of
  the same label's group here; the critic's is a plain Adam.  The JAX
  state covers the whole params view under ``--fast-grads`` too (its
  gradients are scattered back, ``optim.py:184-200``), so one mapping
  serves both.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["hpvaegan_group_plan", "baselines_group_plan", "group_plan",
           "build_g_optimizer", "build_d_optimizer", "freeze_frozen",
           "hoist_index", "clip_grad_norm_", "reset_adam_",
           "load_jax_g_state",
           "load_jax_d_state", "ADAM_B2", "ADAM_EPS"]

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


def freeze_frozen(cfg, G, scale_idx: int) -> None:
    """``--fast-grads``: ``requires_grad_(False)`` on every parameter the
    plan labels frozen (the trainer undoes it at the scale's end with
    ``G.requires_grad_(True)``)."""
    module_labels, body_labels, _ = group_plan(cfg, G, scale_idx)
    for p in _generator_groups(G, module_labels, body_labels).get(
            "frozen", []):
        p.requires_grad_(False)


def hoist_index(cfg, G, scale_idx: int):
    """The first trainable body stage when ``--hoist-prefix`` applies
    (``steps.py:173-182``): under ``--fast-grads``, the encoder and
    decoder frozen, a frozen prefix of at least one stage and every stage
    after it trainable; else None.  Only generators with split forwards
    (``split_forwards``) hoist."""
    if not (cfg.fast_grads and cfg.hoist_prefix and G.split_forwards):
        return None
    module_labels, body_labels, _ = group_plan(cfg, G, scale_idx)
    trainable = [i for i, lab in enumerate(body_labels) if lab != "frozen"]
    if (all(lab == "frozen" for lab in module_labels.values()) and trainable
            and trainable[0] >= 1
            and all(lab != "frozen" for lab in body_labels[trainable[0]:])):
        return trainable[0]
    return None


def _adam(params, lr: float, cfg, device) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, ADAM_B2),
                            eps=ADAM_EPS,
                            capturable=torch.device(device).type == "cuda")


def build_g_optimizer(cfg, G, scale_idx: int) -> torch.optim.Adam:
    """Fresh per-scale generator Adam over the plan's trainable groups."""
    module_labels, body_labels, lrs = group_plan(cfg, G, scale_idx)
    groups = _generator_groups(G, module_labels, body_labels)
    return _adam([{"params": groups[label], "lr": lr}
                  for label, lr in lrs.items()], cfg.lr_g, cfg, G.device)


def build_d_optimizer(cfg, D) -> torch.optim.Adam:
    return _adam(D.parameters(), cfg.lr_d, cfg,
                 next(D.parameters()).device)


@torch.no_grad()
def reset_adam_(opt: torch.optim.Optimizer) -> None:
    """Every moment and step count of ``opt`` to zero, in place: the
    state a fresh Adam makes at its first step, in the same tensors (a
    CUDA graph that captured them keeps reading them)."""
    for state in opt.state.values():
        for v in state.values():
            if isinstance(v, torch.Tensor):
                v.zero_()


def _load_adam(opt: torch.optim.Optimizer, module,
               groups: List[Tuple[Any, Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]]) -> None:
    """``opt``'s state from one optax Adam state ``(count, mu, nu)`` a
    param group (moments by ``module``'s parameter names, in the port's
    layout); ``load_state_dict`` places them on the parameters' device
    (``step`` there too when capturable)."""
    names = {id(p): n for n, p in module.named_parameters()}
    sd = opt.state_dict()
    for group, sd_group, (count, mu, nu) in zip(opt.param_groups,
                                                sd["param_groups"], groups):
        step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
        for p, idx in zip(group["params"], sd_group["params"]):
            name = names[id(p)]
            sd["state"][idx] = {"step": step.clone(),
                                "exp_avg": mu[name].clone(),
                                "exp_avg_sq": nu[name].clone()}
    opt.load_state_dict(sd)


def load_jax_g_state(opt: torch.optim.Optimizer, cfg, G, scale_idx: int,
                     gvars: Mapping[str, Any],
                     opt_state: Mapping[str, Any]) -> None:
    """``opt`` (``build_g_optimizer``'s) from a JAX generator optax state
    over the variables ``gvars``, label by label of the same plan."""
    from ..utils.convert import generator_moments
    inner = opt_state if "inner_states" in opt_state else opt_state["1"]
    _, _, lrs = group_plan(cfg, G, scale_idx)
    groups = []
    for label in lrs:
        adam = inner["inner_states"][label]["inner_state"]["0"]
        groups.append((adam["count"],
                       generator_moments(G, gvars, adam["mu"]),
                       generator_moments(G, gvars, adam["nu"])))
    _load_adam(opt, G, groups)


def load_jax_d_state(opt: torch.optim.Optimizer, D,
                     dvars: Mapping[str, Any],
                     opt_state: Mapping[str, Any]) -> None:
    """``opt`` (``build_d_optimizer``'s) from a JAX critic Adam state
    ``(ScaleByAdamState, EmptyState)`` over the variables ``dvars``."""
    from ..utils.convert import critic_moments
    adam = opt_state["0"] if "0" in opt_state else opt_state
    _load_adam(opt, D, [(adam["count"], critic_moments(D, dvars, adam["mu"]),
                         critic_moments(D, dvars, adam["nu"]))])


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
