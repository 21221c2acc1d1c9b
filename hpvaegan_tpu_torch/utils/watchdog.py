"""Hang watchdog for long runs (a copy of ``hpvaegan_tpu/utils/watchdog.py``).

``Watchdog`` is a daemon thread that checks a heartbeat the training loop
updates after every step.  If the heartbeat goes stale for longer than
``timeout_s``, it logs a CRITICAL diagnosis and ends the process with exit
code 75 (EX_TEMPFAIL): the per-scale checkpoints and ``--netG
<experiment>/netG`` resume let an outer wrapper relaunch the run and lose
at most the current scale's progress.  The timeout must exceed the
longest legitimate gap between steps (the kernels' first build included).
``--watchdog 0`` (the default) disables it.
"""
from __future__ import annotations

import logging
import os
import threading
import time

__all__ = ["Watchdog"]


class Watchdog:
    def __init__(self, timeout_s: float, context: str = "",
                 on_fire=None, poll_s: float | None = None):
        """``on_fire(age_s, context)`` replaces the default log + exit(75)
        (used by tests)."""
        self.timeout_s = float(timeout_s)
        self.context = context
        self._on_fire = on_fire or self._default_fire
        self._poll_s = poll_s if poll_s is not None \
            else max(1.0, self.timeout_s / 4.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Watchdog":
        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="hang-watchdog")
            self._thread.start()
        return self

    def beat(self, context: str | None = None) -> None:
        """The loop made progress."""
        if context is not None:
            self.context = context
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            age = time.monotonic() - self._last
            if age > self.timeout_s:
                self._on_fire(age, self.context)
                return

    @staticmethod
    def _default_fire(age: float, context: str) -> None:
        logging.critical(
            f"watchdog: no training progress for {age:.0f}s "
            f"(last: {context or 'unknown'}).  Exiting 75 (EX_TEMPFAIL); "
            f"resume from the last per-scale checkpoint with --netG "
            f"<experiment>/netG.")
        logging.shutdown()
        os._exit(75)
