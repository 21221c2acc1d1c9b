"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each a gap that a limit bounds.

Training, the first steps of the scale (through the window's own call),
which the reference follows from the start:

* ``loss_gap``: over the first three of them (``LOSS_STEPS``), the
  largest of each step's loss gaps as the model family's ``loss_gaps``
  scales them (HP-VAE-GAN: the generator's total loss and the critic's,
  ``errD_real + errD_fake + gradient_penalty``, each over the sum of its
  terms' magnitudes in the reference);
* ``grad_gap``: over the trained leaves (the generator's trained stages
  and the critic), the largest gap between the norms of the first step's
  gradient as each optimizer got it, ``| |g_p| - |g_r| |``, over the
  larger of ``|g_r|`` and the median leaf's;
* ``change_gap``: the same of the norms of each leaf's change over the
  compared steps, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (round-off moves them, as a
  bias before BatchNorm).

and the window's last step (eager) or chunk (replayed), which the
reference takes from the program's own state before it (its optimizers'
included), as it cannot follow the whole window in less time:

* ``window_loss_gap``: ``loss_gap`` of its first three steps or fewer;
* ``window_change_gap``: ``change_gap`` of each leaf's change over it,
  the same leaves left out.

Sampling: ``clip_gap``, the largest absolute difference of a compared
request's clips from the reference's (values in [-1, 1])."""
from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List

__all__ = ["train_gaps", "window_gaps", "leaf_gap", "TINY_GRAD",
           "LOSS_STEPS"]

TINY_GRAD = 1e-3
LOSS_STEPS = 3   # the steps whose losses are compared, from a given start
# a step's loss gaps from its losses and the reference's, in the model
# family's ``LOSS_TERMS`` order: the family's ``loss_gaps`` with its
# configuration
StepGaps = Callable[[tuple, tuple], List[float]]


def leaf_gap(got: Dict[str, float], ref: Dict[str, float], keep=None
             ) -> float:
    """The worst leaf's ``|got - ref| / max(ref, median ref)``; a leaf on
    one side only counts as infinite."""
    if set(got) != set(ref):
        return math.inf
    median = statistics.median(r for n, r in ref.items()
                               if keep is None or n in keep)
    worst = 0.0
    for name, r in ref.items():
        if keep is not None and name not in keep:
            continue
        g = got[name]
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - r) / max(r, median))
    return worst


def _losses_gap(losses: List[tuple], want: List[tuple],
                step_gaps: StepGaps) -> float:
    if len(losses) != len(want):
        return math.inf
    gaps = [[math.inf] if not all(math.isfinite(v) for v in got)
            else step_gaps(got, w)
            for got, w in list(zip(losses, want))[:LOSS_STEPS]]
    return max(g for step in gaps for g in step)


def _moving(ref_grads: Dict[str, float]) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grads.values())
    return {n for n, g in ref_grads.items() if g >= TINY_GRAD * median}


def train_gaps(losses: List[tuple], grads: Dict[str, float],
               change: Dict[str, float], ref: dict, step_gaps: StepGaps
               ) -> Dict[str, float]:
    """The three gaps of the scale's first steps against the reference's
    (the model family's ``follow``'s result)."""
    return {"loss_gap": _losses_gap(losses, ref["losses"], step_gaps),
            "grad_gap": leaf_gap(grads, ref["grads"]),
            "change_gap": leaf_gap(change, ref["change"],
                                   keep=_moving(ref["grads"]))}


def window_gaps(losses: List[tuple], change: Dict[str, float], ref: dict,
                ref_grads: Dict[str, float], step_gaps: StepGaps
                ) -> Dict[str, float]:
    """The two gaps of the window's last step or chunk against the
    reference's (the model family's ``resume``'s result); the leaves left
    out by the first steps' reference gradients ``ref_grads``."""
    return {"window_loss_gap": _losses_gap(losses, ref["losses"],
                                           step_gaps),
            "window_change_gap": leaf_gap(change, ref["change"],
                                          keep=_moving(ref_grads))}
