"""``--scan-steps K`` on the card: a training step captured once as a CUDA
graph and replayed (the counterpart of the JAX package's K iterations in
one ``lax.scan`` dispatch, ``train/steps.py:248-262, 380-445``).

``StepGraph`` wraps one step of one (scale, phase): a function of a tree
of input tensors (the batch, or the device cache's rows, and every draw
of the iteration) that runs the whole step, the optimizers' updates
included, and returns its metrics.  Its first call runs the step eagerly,
as a genuine step, on a side stream: that loads the kernels' libraries
and their ``cudaFuncSetAttribute`` calls, cuDNN's handles, the
optimizers' state and autograd's lazy state.  The second call captures
the step into a graph, with static copies of the inputs, and every call
from then on copies its inputs into those buffers and replays the graph.
The metrics come back as clones, so a chunk keeps every iteration's.

Primed (``prime``, for ``--compile-ahead``, ``train/precompile.py``):
during the scale before, one warm-up step runs on stand-in inputs, what
it changed is undone (``reset``), and the capture runs on those inputs;
every call from then on, the first included, replays (without the
capture, a warm-up alone: the eager first step then comes later).  The
eager steps and the capture run on the graph's own two streams, never
on the default capture stream that every ``torch.cuda.graph`` shares.

What makes a step capturable (and the port's steps are):

* no host synchronisation and no draw inside: the trainer draws
  everything ahead (``steps.gan_draws``, ``G.draw_eps``) from the
  iteration's generator, so a replay sees the numbers an eager step
  would have drawn;
* every device buffer allocated through torch, every kernel launched on
  ``torch.cuda.current_stream()`` (the kernels' wrappers do);
* the optimizers ``capturable`` (``optim._adam``: on CUDA always, so
  that an eager step and a replayed one run one update rule);
* host-side flags (``full_f32()``, ``deterministic()``, ``requires_grad``
  of the frozen critic) set inside the step, so the capture records the
  kernels they choose; the GP's double backward, BatchNorm's running
  statistics and the spectral power iteration are device work, captured.

A failed capture raises; nothing falls back to eager steps.  The kernels'
launch counters are Python-side: a capture counts its launches once and
a replay not at all, so replayed launches are counted from the
profiler's device kernel events (``chip_smoke.py`` phase 14).
``close`` frees the graph, its memory pool and the gradients that live
there.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import torch

from ..utils.profiling import span

__all__ = ["StepGraph"]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_into(static, tree) -> None:
    if isinstance(static, torch.Tensor):
        if static.shape != tree.shape:
            raise ValueError(f"a replay's input of shape {tuple(tree.shape)}"
                             f" for the captured {tuple(static.shape)}")
        static.copy_(tree)
    elif isinstance(static, dict):
        for k, v in static.items():
            _copy_into(v, tree[k])
    elif isinstance(static, (list, tuple)):
        for a, b in zip(static, tree):
            _copy_into(a, b)


class StepGraph:
    """``step(inputs) -> metrics`` run eagerly once, then captured and
    replayed.  ``modules``: the modules whose gradients the step makes
    (their ``.grad`` live in the graph's pool once it is captured)."""

    def __init__(self, step: Callable[[dict], Dict[str, torch.Tensor]],
                 device, modules=()):
        self._step = step
        self._device = torch.device(device)
        self._modules = list(modules)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static = None
        self._out = None
        # the eager steps run on one stream, the capture on another: its
        # own, never the default capture stream that every
        # torch.cuda.graph shares
        self.streams = (torch.cuda.Stream(self._device),
                        torch.cuda.Stream(self._device))
        self.eager_steps = 0
        self.replays = 0
        self.pool_bytes = 0   # reserved by the capture

    def __call__(self, inputs: dict) -> Dict[str, torch.Tensor]:
        if self._graph is None and self.eager_steps == 0:
            self.eager_steps += 1
            return self._eager(inputs)
        if self._graph is None:
            self._capture(inputs)
        with span("graph.replay"):
            _copy_into(self._static, inputs)
            self._graph.replay()
            self.replays += 1
            return {k: v.clone() for k, v in self._out.items()}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def prime(self, inputs: dict, reset: Callable[[], None],
              capture: bool = True) -> None:
        """Warm up on ``inputs`` (a stand-in of the real ones, same
        shapes), call ``reset()`` to undo the warm-up's changes, and
        capture on ``inputs`` (unless ``capture`` is false): the first
        call then replays."""
        self._eager(inputs)
        reset()
        if capture:
            self._capture(inputs)

    def _eager(self, inputs: dict) -> Dict[str, torch.Tensor]:
        side = self.streams[0]
        side.wait_stream(torch.cuda.current_stream(self._device))
        with torch.cuda.stream(side):
            out = self._step(inputs)
        torch.cuda.current_stream(self._device).wait_stream(side)
        return out

    def _capture(self, inputs: dict) -> None:
        self._static = _clone(inputs)
        # the capture starts from an emptied cache (torch.cuda.graph
        # empties it too): what it reserves beyond is the graph's pool
        torch.cuda.synchronize(self._device)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self._device)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the host loader's thread (--host-loader) may pin
        # and copy the next batches while this thread captures, and the
        # compile-ahead thread may build the next scale's state
        with torch.cuda.graph(graph, stream=self.streams[1],
                              capture_error_mode="thread_local"):
            self._out = self._step(self._static)
        self._graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(self._device) - before

    def close(self) -> None:
        """Free the graph, its pool and the gradients allocated there."""
        for m in self._modules:
            m.zero_grad(set_to_none=True)
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._static = self._out = None
        if self._device.type == "cuda":
            torch.cuda.empty_cache()
