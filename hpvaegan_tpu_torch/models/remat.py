"""``--remat`` and ``--remat-blocks``: rematerialisation (port of the JAX
package's ``_remat_level``/``_apply_bn_module``, ``generators.py:47-90``,
and ``apply_disc(remat=...)``, ``train/steps.py:43-80``).

``jax.checkpoint`` becomes ``torch.utils.checkpoint`` in its
non-reentrant form: the wrapped forward keeps only its inputs, and the
backward that needs its activations runs it again.  The levels, read
from the config at call time so that an escalation
(``train/fallback.py``) takes effect at the next forward:

* ``False``: nothing is wrapped;
* ``True`` (``--remat``): every refinement stage, the VAE decoder and the
  critic's whole forward;
* ``"blocks"`` (``--remat-blocks``, with or without ``--remat``, as in
  the JAX package): the same, and inside each of them every conv block
  and the tail conv.

Two things a recompute must not repeat:

* BatchNorm running statistics: a forward asked to move them
  (``update_stats``) moves them in its first run only; the recompute
  runs with ``update_stats=False`` (PARITY.md deviation 2: one update per
  forward the step threads).  Train-mode BatchNorm normalises with the
  batch's statistics, so the recomputed activations are the first run's;
* draws: ``preserve_rng_state=False``.  No wrapped forward draws (the
  steps draw every number ahead, ``train/steps.gan_draws``), and a CUDA
  graph capture (``train/graphs.py``) may not stash the RNG state.

Without gradient recording (``torch.no_grad``, inference) nothing is
wrapped: there is no backward to recompute for.  The kernels'
``autograd.Function``s (K1, K2, K4's halo) run again in the recompute,
so their launches grow by the recomputed forwards.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["remat_level", "remat"]

Level = Union[bool, str]


def remat_level(cfg) -> Level:
    """``False`` | ``True`` (stage level) | ``"blocks"`` (also every conv
    block), from ``cfg.remat`` and ``cfg.remat_blocks``."""
    if getattr(cfg, "remat_blocks", False):
        return "blocks"
    return bool(getattr(cfg, "remat", False))


def remat(fn: Callable, *args, enabled: Level = True,
          update_stats: Optional[bool] = None, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward when
    ``enabled`` and gradients are recorded.  ``update_stats`` (None: not
    an argument of ``fn``) is passed as a keyword, true in ``fn``'s first
    run only."""
    if update_stats is not None:
        kwargs["update_stats"] = update_stats
    if not enabled or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    runs = [0]

    def run(*a):
        if update_stats and runs[0]:
            kwargs["update_stats"] = False
        runs[0] += 1
        return fn(*a, **kwargs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
