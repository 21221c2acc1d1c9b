"""Which counter a launch goes to: the kernels' ``counts`` (the main
path's), or their ``ahead_counts`` for the work ``--compile-ahead`` does
beside it (``train/precompile.py``).

The ahead work runs on a thread of its own, but a CUDA backward runs on
the autograd engine's device thread, on the streams of its forward: so a
launch counts apart when it is made on a thread inside
``counted_apart()`` or, on the card, on one of the streams that block
named.  The main path's launches keep their counts whatever runs beside
it."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable

import torch

__all__ = ["counted_apart", "is_apart", "pick"]

_local = threading.local()
_streams: set = set()   # raw handles of the streams that count apart
_lock = threading.Lock()


@contextlib.contextmanager
def counted_apart(streams: Iterable = ()):
    """Within: this thread's launches, and every launch on ``streams``
    (``torch.cuda.Stream``s), count in the kernels' ``ahead_counts``."""
    keys = {s.cuda_stream for s in streams}
    with _lock:
        _streams.update(keys)
    _local.apart = True
    try:
        yield
    finally:
        _local.apart = False
        with _lock:
            _streams.difference_update(keys)


def is_apart(x: torch.Tensor) -> bool:
    """Does a launch on ``x``'s device, now, count apart?"""
    if getattr(_local, "apart", False):
        return True
    return bool(_streams) and x.is_cuda and \
        torch.cuda.current_stream(x.device).cuda_stream in _streams


def pick(x: torch.Tensor, counts, ahead_counts):
    """``ahead_counts`` when a launch on ``x`` counts apart, else
    ``counts``."""
    return ahead_counts if is_apart(x) else counts
