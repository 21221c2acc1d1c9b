"""Multi-process correctness helpers (port of
``hpvaegan_tpu/parallel/multihost.py:36-98``).

Under a run of several ranks three single-process assumptions of the
trainer break, as in the JAX package:

* every rank would create its own ``experiment_N`` directory and race
  duplicate checkpoint and event writes: only rank 0 writes, and the run
  id is agreed;
* an unseeded run would draw a different ``manualSeed`` a rank and train
  silently different models: the seed is agreed;
* a file only rank 0 reads (a critic warm start) must reach the others:
  rank 0 reads it and broadcasts the state.

Every value fed to a step (loader indices and flips, draws, amps) is a
pure function of the agreed seed, so each rank holds the same copy and
cuts its own block from it (``parallel/mesh.py``).  Each helper is a
no-op in a single process.  The JAX package's ``global_put`` has no
counterpart: a rank's block is cut from its own whole copy
(``Mesh.shard``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as _dist

__all__ = ["is_primary", "agree", "broadcast_pytree", "barrier", "fetch"]


def is_primary() -> bool:
    """True on the rank allowed to touch the experiment tree."""
    return _dist.process_index() == 0


def agree(value: int) -> int:
    """Rank 0's value, on every rank (run ids, drawn seeds)."""
    if _dist.process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    return int(_dist.broadcast_(t, src=0)[0])


def broadcast_pytree(tree: Any) -> Any:
    """Rank 0's tensors, on every rank, in place: ``tree`` is a tensor, or
    a dict / list / tuple of them (a state dict).  Other ranks pass a
    tree of the same structure and shapes (a fresh module's state dict)
    whose values are overwritten."""
    if _dist.process_count() == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        return _dist.broadcast_(tree, src=0)
    if isinstance(tree, dict):
        return {k: broadcast_pytree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_pytree(v) for v in tree)
    return tree


def barrier(name: str) -> None:
    """Cross-rank sync point (a no-op in one process); ``name`` says which
    in an error."""
    if _dist.process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as exc:
            raise RuntimeError(f"barrier {name!r} failed") from exc


def fetch(x: Any, mesh=None, h_dim: int = 2) -> np.ndarray:
    """Device -> host numpy.  Under ``mesh`` ``x`` is this rank's block
    (batch over data, H, at ``h_dim``, over spatial) and the whole tensor
    is gathered first: every rank must call it."""
    if isinstance(x, torch.Tensor):
        if mesh is not None:
            x = mesh.gather_whole(x.detach(), h_dim)
        return x.detach().float().cpu().numpy()
    return np.asarray(x)

