"""K3: the fused 3x3x3 SAME conv + bias + LeakyReLU(0.2) for any channel
count, as a CUDA kernel.

Replaces ``conv3d_lrelu_pallas`` (``hpvaegan_tpu/ops/pallas/conv3d.py:138``)
and its custom VJP ``conv3d_lrelu`` (``:203-231``):

    y = lrelu(conv3d(x, w, SAME zeros, stride 1) + b, 0.2)

x ``(B,T,H,W,C_in)`` NTHWC, w ``(3,3,3,C_in,C_out)`` THWIO, b ``(C_out,)``,
y f32.  The kernel (``csrc/conv3d_lrelu.cu``) computes in f32 on the CUDA
cores; a bf16 x is widened to f32 first, as the Pallas kernel stages its
input in an f32 window (``conv3d.py:187``).  It takes every T: the Pallas
function hands T < 3 (and shapes without a VMEM fit) to XLA's conv, which
is the same function.

The backward is the JAX VJP's (``:215-228``), which runs in XLA there and
so runs on stock PyTorch calls here: the LeakyReLU mask from the sign of
the saved output, then ``torch.nn.grad.conv3d_input`` and
``conv3d_weight`` and a sum for ``db``, in full f32.

The kernel has three instances, chosen from (C_in, C_out) by
``k3_instance``: ``wide`` (the 64 -> 64 body conv), ``narrow_in`` (C_in
<= 4: the 3 -> 64 encoder head) and ``narrow_out`` (C_out <= 8: the 64 ->
3 tail).  Each is persistent: ``k3_plan`` sizes the grid from the
kernel's own report (``kernel_config``) and the shape.

The JAX package routes this function nowhere (only its tests call it), so
no path of the port does either: it is tested on its own, and
``chip_smoke.py`` drives it in a phase of its own.

On CPU tensors the plain version runs; on CUDA tensors the kernel launches
or the call raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ... import full_f32
from ._counting import pick

__all__ = ["conv3d_lrelu", "conv3d_lrelu_plain", "conv3d_lrelu_forward",
           "Conv3dLReLUFunction", "counts", "ahead_counts", "LReLUCounts", "kernel_config",
           "k3_instance", "k3_plan", "K3Plan", "INSTANCES", "NEG_SLOPE",
           "SOURCE", "REPLACES"]

SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_lrelu.cu"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d.py:138"
NEG_SLOPE = 0.2  # the reference's LeakyReLU slope (networks_3d.py:21)
# the kernel's instances, in the order of its C interface's ids
INSTANCES = ("wide", "narrow_in", "narrow_out")
_CONFIG = ("threads", "smem_bytes", "blocks_per_sm", "tile_h", "tile_w",
           "co_blk", "ci_chunk", "stages", "resident_bytes")
_INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class LReLUCounts:
    """``launches``: kernel launches (``by_instance``: of each instance);
    ``plain_calls``: forwards served by the plain version (CPU tensors)."""

    launches: int = 0
    plain_calls: int = 0
    by_instance: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.launches = self.plain_calls = 0
        self.by_instance = {}


counts = LReLUCounts()
ahead_counts = LReLUCounts()   # --compile-ahead's (``_counting.py``)


def _nc(x: torch.Tensor) -> torch.Tensor:
    """NTHWC -> NCDHW view."""
    return x.permute(0, 4, 1, 2, 3)


def _oi(w: torch.Tensor) -> torch.Tensor:
    """THWIO -> PyTorch's (O, I, 3, 3, 3) view."""
    return w.permute(4, 3, 0, 1, 2)


def _lrelu(y: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(y >= 0, y, slope * y)


def conv3d_lrelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       neg_slope: float = NEG_SLOPE) -> torch.Tensor:
    """``F.conv3d`` + bias + LeakyReLU in full f32 (the XLA reference,
    ``conv3d.py:194-200``), NTHWC in and out."""
    with full_f32():
        y = F.conv3d(_nc(x.float()), _oi(w.float()), b.float(), padding=1)
    return _lrelu(y.permute(0, 2, 3, 4, 1), neg_slope).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"x must be (B,T,H,W,C_in), got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, c_in):
        raise ValueError(f"w must be (3,3,3,{c_in},C_out), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"b must be ({w.shape[-1]},), got {tuple(b.shape)}")
    for t in (x, w, b):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"conv3d_lrelu takes float32 or bfloat16 tensors, got "
                f"{t.dtype}")
        if t.device != x.device:
            raise ValueError("x, w and b must share a device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d_lrelu runs on CUDA or CPU tensors, got "
                         f"{x.device}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare the C interface."""
    from ._build import load_library
    lib = load_library("conv3d_lrelu")
    lib.conv3d_lrelu_f32.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 6
                                     + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p])
    lib.conv3d_lrelu_f32.restype = ctypes.c_int
    lib.conv3d_lrelu_f32_config.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    lib.conv3d_lrelu_f32_config.restype = ctypes.c_int
    return lib


def k3_instance(c_in: int, c_out: int) -> str:
    """The kernel instance for ``c_in`` -> ``c_out`` channels:
    ``narrow_out`` for C_out <= 8, else ``narrow_in`` for C_in <= 4, else
    ``wide``."""
    if c_in < 1 or c_out < 1:
        raise ValueError(f"channel counts must be positive, got {c_in}, "
                         f"{c_out}")
    if c_out <= 8:
        return "narrow_out"
    return "narrow_in" if c_in <= 4 else "wide"


def kernel_config(c_in: int, c_out: int,
                  device: Optional[int] = None) -> dict:
    """The launch configuration of the instance for ``c_in`` -> ``c_out``
    on ``device`` (the current one by default): its name, threads and
    dynamic shared memory of a block, blocks an SM (CUDA's occupancy API),
    the output tile (rows, columns, channels), input channels a stage,
    ring stages and the bytes of weights a block keeps resident.  Builds
    the kernel if needed."""
    if device is None:
        device = torch.cuda.current_device()
    return dict(_config(k3_instance(c_in, c_out), c_in, c_out, device))


@functools.lru_cache(maxsize=None)
def _config(instance: str, c_in: int, c_out: int, device: int) -> tuple:
    vals = (ctypes.c_int * len(_CONFIG))()
    with torch.cuda.device(device):
        err = _lib().conv3d_lrelu_f32_config(INSTANCES.index(instance),
                                             c_in, c_out, vals)
    if err != 0:
        raise RuntimeError(f"conv3d_lrelu config failed with CUDA error "
                           f"{err}")
    cfg = dict(zip(_CONFIG, vals), instance=instance)
    if cfg["blocks_per_sm"] < 1:
        raise RuntimeError(f"the {instance} instance fits no block on an "
                           f"SM: {cfg}")
    return tuple(cfg.items())


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """A persistent launch of ``grid`` blocks over ``ntiles`` output tiles.

    ``wide`` and ``narrow_in`` walk the tiles round-robin (block i takes
    tiles i, i + grid, ...), tile index ``(((b * T + t) * tiles_h + th) *
    tiles_w + tw) * co_blocks + cb``; narrow_in's grid is a multiple of
    ``co_blocks``, so each block keeps one channel block's weights.
    ``narrow_out`` (``co_blocks`` 1) gives block i the contiguous run of
    tiles ``[i * ntiles // grid, (i + 1) * ntiles // grid)`` in the order
    ``((b * tiles_h + th) * tiles_w + tw) * T + t``: T innermost, so a
    block streams through the frames of a spatial tile."""

    instance: str
    tiles_h: int
    tiles_w: int
    co_blocks: int
    ntiles: int
    grid: int


def k3_plan(shape, c_out: int, sms: int, cfg: dict) -> K3Plan:
    """The launch of x ``shape`` ``(B, T, H, W, C_in)`` -> ``c_out``
    channels on a card of ``sms`` SMs, with the instance's report ``cfg``
    (``kernel_config``: ``blocks_per_sm``, ``tile_h``, ``tile_w``,
    ``co_blk``): one wave of resident blocks, never more blocks than
    tiles, at least one."""
    B, T, H, W, c_in = shape
    instance = k3_instance(c_in, c_out)
    if cfg.get("instance", instance) != instance:
        raise ValueError(f"{c_in} -> {c_out} channels take the {instance} "
                         f"instance, not {cfg['instance']}")
    tiles_h, tiles_w = -(-H // cfg["tile_h"]), -(-W // cfg["tile_w"])
    co_blocks = -(-c_out // cfg["co_blk"])
    ntiles = B * T * tiles_h * tiles_w * co_blocks
    if ntiles > _INT_MAX:
        raise ValueError(f"{ntiles} output tiles: the kernel indexes at "
                         f"most {_INT_MAX}")
    grid = max(1, min(ntiles, sms * cfg["blocks_per_sm"]))
    if instance == "narrow_in":
        grid = max(co_blocks, grid // co_blocks * co_blocks)
    return K3Plan(instance, tiles_h, tiles_w, co_blocks, ntiles, grid)


def conv3d_lrelu_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         neg_slope: float = NEG_SLOPE) -> torch.Tensor:
    """The forward alone, f32 out: the plain version on CPU tensors, else
    the kernel."""
    _check(x, w, b)
    if x.device.type == "cpu":
        pick(x, counts, ahead_counts).plain_calls += 1
        return conv3d_lrelu_plain(x, w, b, neg_slope)
    x, w, b = (t.float().contiguous() for t in (x, w, b))
    B, T, H, W, c_in = x.shape
    c_out = w.shape[-1]
    y = torch.empty((B, T, H, W, c_out), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        dev = torch.cuda.current_device()
        plan = k3_plan(
            x.shape, c_out,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            kernel_config(c_in, c_out, dev))
        err = _lib().conv3d_lrelu_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            B, T, H, W, c_in, c_out, float(neg_slope),
            INSTANCES.index(plan.instance), plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_lrelu kernel launch failed with CUDA "
                           f"error {err}")
    c = pick(x, counts, ahead_counts)
    c.launches += 1
    c.by_instance[plan.instance] = c.by_instance.get(plan.instance, 0) + 1
    return y


class Conv3dLReLUFunction(torch.autograd.Function):
    """``conv3d_lrelu_forward`` with the JAX VJP's backward
    (``conv3d.py:215-228``) on stock calls in full f32; gradients come
    back in each input's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, neg_slope):
        y = conv3d_lrelu_forward(x, w, b, neg_slope)
        ctx.neg_slope = neg_slope
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dpre = torch.where(y >= 0, dy, ctx.neg_slope * dy).float()
        dx = dw = db = None
        with full_f32():
            if need_x:
                dx = torch.nn.grad.conv3d_input(
                    _nc(x).shape, _oi(w.float()), _nc(dpre), padding=1)
                dx = dx.permute(0, 2, 3, 4, 1).to(ctx.dtypes[0])
            if need_w:
                dw = torch.nn.grad.conv3d_weight(
                    _nc(x.float()), _oi(w).shape, _nc(dpre), padding=1)
                dw = dw.permute(2, 3, 4, 1, 0).to(ctx.dtypes[1])
        if need_b:
            db = dpre.sum(dim=(0, 1, 2, 3)).to(ctx.dtypes[2])
        return dx, dw, db, None


def conv3d_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 neg_slope: float = NEG_SLOPE) -> torch.Tensor:
    """Differentiable fused conv3d + bias + LeakyReLU (the JAX package's
    ``conv3d_lrelu``): the kernel forward on CUDA tensors, the plain one
    on CPU tensors, the stock backward on either."""
    _check(x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return Conv3dLReLUFunction.apply(x, w, b, neg_slope)
    return conv3d_lrelu_forward(x, w, b, neg_slope)
