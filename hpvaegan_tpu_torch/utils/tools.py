"""A progress reporter mirrored into the logbook (port of
``hpvaegan_tpu/utils/tools.py``; reference utils/tools.py:12-159), and
the seeded ``torch.Generator`` that every entry point draws from.

The JAX package subclasses ``tqdm``; the machine with the card has no
``tqdm``, so this is a small bar of its own on stderr: ``desc: pct%|
n/total [elapsed<remaining, rate]``.  On a terminal it redraws one line;
elsewhere (logs, captured output) it writes a line at most every 10 s.
As the JAX bar does (``tools.py:49-53``), its last state is mirrored into
the logbook at the file-only LOGBOOK level on ``close``.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .logger import logbook as _logbook

__all__ = ["ProgressBar", "create_progressbar", "seed_value",
           "seeded_generator"]

_LOG_INTERVAL_S = 10.0   # between lines when stderr is not a terminal


def _clock(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"


class ProgressBar:
    def __init__(self, total: int, desc: str = "", initial: int = 0):
        self.total = total
        self.desc = desc
        self.n = self._n0 = int(initial)
        self._tty = sys.stderr.isatty()
        self._interval = 0.1 if self._tty else _LOG_INTERVAL_S
        self._t0 = time.perf_counter()
        self._last_draw = float("-inf")
        self._closed = False

    def __str__(self) -> str:
        elapsed = time.perf_counter() - self._t0
        done = self.n - self._n0
        rate = done / elapsed if elapsed > 0 and done else 0.0
        left = (self.total - self.n) / rate if rate else 0.0
        pct = 100.0 * self.n / self.total if self.total else 100.0
        body = (f"{pct:3.0f}%| {self.n}/{self.total} [{_clock(elapsed)}<"
                f"{_clock(left)}, {rate:.2f}it/s]")
        return f"{self.desc}: {body}" if self.desc else body

    def _draw(self, force: bool = False) -> None:
        now = time.perf_counter()
        if not force and now - self._last_draw < self._interval:
            return
        self._last_draw = now
        if self._tty:
            sys.stderr.write("\r" + str(self) + "\x1b[K")
        else:
            sys.stderr.write(str(self) + "\n")
        sys.stderr.flush()

    def update(self, n: int = 1) -> None:
        self.n += int(n)
        self._draw()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._draw()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._draw(force=True)
        if self._tty:
            sys.stderr.write("\n")
            sys.stderr.flush()
        _logbook(str(self))


def create_progressbar(total: int, desc: str = "",
                       initial: int = 0) -> ProgressBar:
    """The bar factory, with the arguments of the JAX package's that the
    port's trainer uses."""
    return ProgressBar(total=total, desc=desc, initial=initial)


def seed_value(seed: int, *key: int) -> int:
    """The 64-bit seed that ``seeded_generator(seed, *key)`` gives its
    generator (numpy's ``SeedSequence`` mixes them)."""
    state = np.random.SeedSequence(entropy=int(seed),
                                   spawn_key=tuple(int(k) for k in key))
    return int(state.generate_state(1, np.uint64)[0])


def seeded_generator(seed: int, *key: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` whose state depends only on
    ``(seed, *key)``."""
    return torch.Generator(device=device).manual_seed(seed_value(seed, *key))
