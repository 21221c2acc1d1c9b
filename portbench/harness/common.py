"""Small device helpers shared by the cell runners, and the record of one
run (``Run``) that the result line and the per-layer readers read."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["sync", "peak_bytes", "reserved_peak_bytes", "reset_peak", "Run",
           "note", "Stop", "precision", "control_precision", "fp8_round"]

E4M3_MAX = 448.0   # the largest finite float8_e4m3fn


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


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values rounded to fp8 (e4m3), scaled per tensor so that its
    largest magnitude is e4m3's largest, as an fp8 operand is; the
    gradient passes straight through, to any order."""
    d = t.detach()
    scale = d.abs().amax().clamp_min(torch.finfo(d.dtype).tiny) / E4M3_MAX
    q = (d / scale).to(torch.float8_e4m3fn).to(d.dtype) * scale
    return t + (q - d)


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward hands on its gradient ``fp8_round``ed:
    a convolution's output gradient, the operand of its backward's two
    convolutions."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class _Fp8Convs(TorchFunctionMode):
    """Every convolution called inside computes in fp8 operands with f32
    accumulation, as fp8 tensor cores do: its input and weight
    ``fp8_round``ed, and its output gradient too, the operand of the
    input's and the weight's gradients."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.conv2d, F.conv3d):
            args = (fp8_round(args[0]), fp8_round(args[1]), *args[2:])
            return _Fp8Grad.apply(func(*args, **(kwargs or {})))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def control_precision(bf16: bool):
    """The control's precision inside the block, the nearest below the
    configuration's compute dtype: TF32 for f32 (with TF32 off); for
    bf16, every convolution's operands in fp8 (``_Fp8Convs``), the rest
    f32 with TF32 off."""
    if not bf16:
        with precision(tf32=True):
            yield
        return
    with precision(tf32=False), _Fp8Convs():
        yield


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
