"""Logging: console + color-stripped logbook file, indented blocks (a copy
of ``hpvaegan_tpu/utils/logger.py``; reference utils/logger.py:69-138).

* a ``LOGBOOK`` level 1000 (reference utils/tools.py:77-100) mirrors the
  progress bars: LOGBOOK records reach the logbook FILE and are skipped on
  the console;
* console lines carry a timestamp (dim on a terminal) and emphasized
  section titles (``==>`` in cyan), the file gets color-stripped lines;
* ``LoggingBlock`` context managers indent nested sections;
* ``kept_logging`` gives the root logger's handlers back after a block
  that configures logging (a CLI run in-process).
"""
from __future__ import annotations

import contextlib
import logging
import re
import sys

__all__ = ["configure_logging", "kept_logging", "LoggingBlock", "LOGBOOK",
           "logbook"]

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")
_INDENT = {"level": 0}

# file-only level for the progress-bar mirrors (reference utils/tools.py:84)
LOGBOOK = 1000


def _ensure_logbook_level() -> None:
    if logging.getLevelName(LOGBOOK) != "LOGBOOK":
        logging.addLevelName(LOGBOOK, "LOGBOOK")


def logbook(msg: str) -> None:
    """Log at the LOGBOOK level: written to logbook.txt, skipped on the
    console."""
    _ensure_logbook_level()
    logging.log(LOGBOOK, msg)


class _IndentFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.msg = "  " * _INDENT["level"] + str(record.msg)
        return True


class _SkipLogbookFilter(logging.Filter):
    """The console drops LOGBOOK records (reference utils/logger.py:58-61)."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno != LOGBOOK


class _StripColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return _ANSI_RE.sub("", super().format(record))


def configure_logging(logbook_path) -> None:
    """Console logging plus, unless ``logbook_path`` is None, the logbook
    file (appended).  Replaces the root logger's handlers."""
    _ensure_logbook_level()
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)

    console_fmt = ("\x1b[2m%(asctime)s\x1b[0m %(levelname)s %(message)s"
                   if sys.stdout.isatty()
                   else "%(asctime)s %(levelname)s %(message)s")
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(logging.Formatter(console_fmt, datefmt="%H:%M:%S"))
    console.addFilter(_IndentFilter())
    console.addFilter(_SkipLogbookFilter())
    root.addHandler(console)

    if logbook_path is not None:
        fileh = logging.FileHandler(logbook_path, mode="a")
        fileh.setFormatter(_StripColorFormatter(
            "%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S"))
        root.addHandler(fileh)


@contextlib.contextmanager
def kept_logging():
    """The training CLIs replace the root logger's handlers; give them
    back afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)


class LoggingBlock:
    """Indented logging section (utils/logger.py:122-138)."""

    def __init__(self, title: str, emph: bool = False):
        self.title = title
        self.emph = emph

    def __enter__(self):
        if self.emph:
            logging.info(f"\x1b[36m==>\x1b[0m \x1b[1m{self.title}\x1b[0m")
        else:
            logging.info(self.title)
        _INDENT["level"] += 1
        return self

    def __exit__(self, *exc):
        _INDENT["level"] = max(0, _INDENT["level"] - 1)
        return False
