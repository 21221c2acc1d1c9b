"""Small device helpers shared by the cell runners, and the record of one
run (``Run``) that the result line and the per-layer readers read."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

__all__ = ["sync", "peak_bytes", "reserved_peak_bytes", "reset_peak", "Run",
           "note", "Stop", "precision"]


class Stop(Exception):
    """Raised from the trainer's callback to end the scale once the
    measured window has closed."""


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def reserved_peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" \
        else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's precision inside the block: f32 with TF32 off, as
    the configurations state, or TF32 (``tf32=True``: the control, the
    nearest precision below).  The measured program runs under PyTorch's
    defaults and holds its own precision."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def note(msg: str) -> None:
    """A line of the run's account on standard error."""
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What one run measured and compared.  ``kind`` is ``"train"`` or
    ``"sample"``; a unit is a GAN step or a request."""

    kind: str
    t0: float                              # process start, host clock
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    units: int = 0                         # steps or requests in the window
    failed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    clips: int = 0
    memory_peak_bytes: int = 0             # the process's, through the window
    window_reserved_bytes: int = 0         # reserved peak inside the window
    trace: Optional[object] = None         # TraceSummary of the traced window
    launches: Optional[object] = None      # LaunchLog
    flops_per_unit: int = 0
    peak_flops: float = 0.0                # the compute dtype's peak, FLOP/s
    gp_ms: Optional[float] = None
    # every correctness number the run gave, compared or not
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)

    def mark(self, part: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_parts[part] = self.setup_parts.get(part, 0.0) + now - since
        return now
