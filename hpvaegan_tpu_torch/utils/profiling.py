"""``StepTimer``: amortized steps per second for the progress bar (port of
``hpvaegan_tpu/utils/profiling.py:30-91``).

PyTorch returns from a CUDA step before the card has run it, so a host
clock alone measures the enqueue.  The timer synchronizes the device every
``sync_every`` steps and reports the rate between synchronizations.
Everything up to the first synchronization counts as warm-up (the
kernels' first build, cuDNN's first-call set-up); its rate is shown
flagged as such until the second synchronization.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

__all__ = ["StepTimer"]


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
