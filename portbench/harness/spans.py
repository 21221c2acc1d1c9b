"""Spans of set-up the measured package does not report itself, timed
around its calls: each kernel library's build-and-load
(``ops/kernels/_build.load_library``) and each CUDA graph capture
(``train/graphs.StepGraph._capture``, timed from a synchronisation).
They land in the run's set-up parts as ``of which ...``."""
from __future__ import annotations

import functools
import time

import torch

__all__ = ["SetupSpans"]


class SetupSpans:
    def __init__(self, run, dev: torch.device):
        self.run, self.dev = run, dev
        self._undo = []

    def _time(self, module, name: str, part: str, sync: bool) -> None:
        original = getattr(module, name)
        run, dev = self.run, self.dev

        @functools.wraps(original)
        def timed(*args, **kwargs):
            if sync and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                run.mark(part, t)
        setattr(module, name, timed)
        self._undo.append((module, name, original))

    def install(self) -> "SetupSpans":
        from hpvaegan_tpu_torch.ops.kernels import _build
        from hpvaegan_tpu_torch.train.graphs import StepGraph
        self._time(_build, "load_library", "of which kernel libraries",
                   False)
        self._time(StepGraph, "_capture", "of which graph capture", True)
        return self

    def remove(self) -> None:
        for module, name, original in reversed(self._undo):
            setattr(module, name, original)
        self._undo.clear()
