"""``StepTimer``: amortized steps per second for the progress bar (port of
``hpvaegan_tpu/utils/profiling.py:30-91``); ``span``: a named interval of
the package in a ``torch.profiler`` trace.

PyTorch returns from a CUDA step before the card has run it, so a host
clock alone measures the enqueue.  The timer synchronizes the device every
``sync_every`` steps and reports the rate between synchronizations.
Everything up to the first synchronization counts as warm-up (the
kernels' first build, cuDNN's first-call set-up); its rate is shown
flagged as such until the second synchronization.

``span(name)`` marks where a layer's work happens (the request, the
generator's stages, the trainer's chunk and replay, the GAN step's halves)
as a ``torch.profiler.record_function`` range, which the profiler keeps
beside the kernels and writes out with them (``export_chrome_trace``:
``user_annotation`` events on the trace's clock, which Kineto aligns with
the device's).  A span's parent is the span that encloses it on the same
thread.  Spans exist exactly while a profiler records (``--profile-dir``'s
window, a benchmark's traced window); otherwise ``span`` returns one
shared no-op context after a read of the profiler's module-global flag,
and builds no ``record_function``, whose construction alone costs
microseconds.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["StepTimer", "span"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a ``torch.profiler`` session
    records, else the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _autograd_profiler.record_function(name)


class StepTimer:
    def __init__(self, sync_every: int = 50, device=None):
        self.sync_every = sync_every
        self.device = torch.device(device) if device is not None else None
        self._count = 0
        self._last_sync = 0
        self._t0: Optional[float] = None
        self._warmed = False
        self.steps_per_sec = float("nan")

    def _synchronize(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, n: int = 1) -> None:
        """Call once per step (``n`` iterations)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._count += n
        if self._count - self._last_sync >= self.sync_every:
            self._synchronize()
            now = time.perf_counter()
            self.steps_per_sec = self._count / (now - self._t0)
            if not self._warmed:
                self._warmed = True
                self._t0 = now
                self._count = 0
                self._last_sync = 0
                return
            self._last_sync = self._count

    @property
    def suffix(self) -> str:
        """' | N.NN it/s (amortized)' once a synchronized measurement
        exists; the first is flagged '(incl. warmup)'."""
        if self.steps_per_sec != self.steps_per_sec:  # NaN: none yet
            return ""
        if self._warmed and self._last_sync == 0:
            return f" | {self.steps_per_sec:.2f} it/s (incl. warmup)"
        return f" | {self.steps_per_sec:.2f} it/s (amortized)"
