"""K2: two fused conv + LeakyReLU(0.2) layers, 64 -> 64 -> 64, as a CUDA
kernel.

Replaces ``conv3d64_pair_pallas``
(``hpvaegan_tpu/ops/pallas/conv3d_fuse.py:215``) and its VJP
``conv3d64_pair`` (``:298-345``), which the JAX package runs for the
WDiscriminator body's conv pairs under ``--pfuse``:

    z = lrelu(conv(x, w1) + b1),    y = lrelu(conv(z, w2) + b2)

x ``(B,T,H,W,64)`` NTHWC, w1/w2 ``(3,3,3,64,64)`` THWIO, b1/b2 ``(64,)``,
computed in x's dtype: f32, or bf16 (``--bf16``) with the weights and
biases rounded to bf16, f32 accumulation, and z rounded to bf16 before
conv2 (the TPU kernel's z ring has x's dtype, ``conv3d_fuse.py:173,
282``).  The kernels (``csrc/conv3d_fuse.cu``: f32 on the CUDA cores,
bf16 on the tensor cores with ``wgmma`` fed by TMA) keep z in shared
memory and stream T inside each block through a 3-slot ring of z slices;
with ``with_mid`` they also write z out, the backward's residual.  The
bf16 kernel is persistent: ``pair_plan`` sizes its grid from the
kernel's own report (``kernel_config``).

The backward follows ``conv3d_fuse.py:315-345``: the cotangent is rounded
to x's dtype, the LeakyReLU masks come from the signs of y and z
(LeakyReLU is sign-preserving), dz and dx run on K1's input-gradient
kernel.  dw1 and dw2 run on the port's K1-dw kernel, which computes the
same function as the JAX package's XLA correlation there (``:334-337``):
no feature is added.  In bf16 that correlation has bf16 operands and a
bf16 result, cast to f32; the K1-dw kernel sums in f32, so its f32 result
is rounded to bf16 here to give the JAX package's values.

Routing gate: the geometry only (3D, 3x3x3, 64 -> 64, stride 1, pad 1),
decided by the critic.  The TPU's ``pfuse_wins`` (W % 256) and its VMEM
budget are dropped, as for K1.

On CPU tensors the plain version runs; on CUDA tensors the kernel
launches or the call raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from . import conv3d_pack as cp
from ._counting import pick

__all__ = ["conv3d64_pair", "conv3d64_pair_plain", "conv3d64_pair_forward",
           "conv3d64_pair_backward", "Conv3d64PairFunction", "counts", "ahead_counts",
           "PairCounts", "kernel_config", "pair_plan", "SLOPE", "SOURCE",
           "REPLACES"]

SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_fuse.cu"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_fuse.py:215"
SLOPE = 0.2  # LeakyReLU slope of the critic body (networks_3d.py:18-26)
_CONFIG = {"f32": ("smem_bytes", "threads", "blocks_per_sm"),
           "bf16": ("smem_bytes", "threads", "blocks_per_sm", "tile_h",
                    "tile_w")}


@dataclasses.dataclass
class PairCounts:
    """``launches``/``bf16_launches``: K2 kernel launches in f32 / bf16;
    ``plain_calls``: calls served by the plain version (CPU tensors)."""

    launches: int = 0
    bf16_launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = self.bf16_launches = self.plain_calls = 0


counts = PairCounts()
ahead_counts = PairCounts()   # --compile-ahead's (``_counting.py``)


def conv3d64_pair_plain(x, w1, b1, w2, b2, slope: float = SLOPE,
                        with_mid: bool = False):
    """Two ``conv3d64_plain`` + LeakyReLU: ``y`` or ``(y, z)``, each
    rounded to x's dtype (so conv2 reads the rounded z)."""
    z = cp.conv3d64_plain(x, w1, b1, neg_slope=slope)
    y = cp.conv3d64_plain(z, w2, b2, neg_slope=slope)
    return (y, z) if with_mid else y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library("conv3d_fuse")
    for sfx in ("f32", "bf16"):
        fn = getattr(lib, f"conv3d64_pair_{sfx}")
        # the bf16 instance also takes its persistent grid
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * (sfx == "bf16")
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cfg = getattr(lib, f"conv3d64_pair_{sfx}_config")
        cfg.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(_CONFIG[sfx])
        cfg.restype = ctypes.c_int
    return lib


def kernel_config(dtype: torch.dtype = torch.float32,
                  device=None) -> dict:
    """Dynamic shared memory and threads of one block in ``dtype``, and
    blocks an SM on ``device`` (CUDA's occupancy API; the current device
    by default); for bf16 also the output tile (rows, columns).  Builds
    the kernel if needed."""
    if device is None:
        device = torch.cuda.current_device()
    return _config(cp._suffix(dtype), device)


@functools.lru_cache(maxsize=None)
def _config(sfx: str, device: int) -> dict:
    vals = [ctypes.c_int() for _ in _CONFIG[sfx]]
    with torch.cuda.device(device):
        err = getattr(_lib(), f"conv3d64_pair_{sfx}_config")(
            *(ctypes.byref(v) for v in vals))
    cp._raise_on(err, "conv3d64_pair config")
    cfg = dict(zip(_CONFIG[sfx], (v.value for v in vals)))
    if cfg["blocks_per_sm"] < 1:
        raise RuntimeError(f"the {sfx} pair kernel fits no block on an SM: "
                           f"{cfg}")
    return cfg


def pair_plan(sms: int, blocks_per_sm: int, tile_h: int, tile_w: int,
              shape) -> cp.FwdPlan:
    """The persistent grid of a bf16 pair launch for ``shape`` ``(B, T,
    H, W)``: its tiles are the ``(b, tile row, tile column)`` columns, each
    walked through all of T by one block (``ntiles`` counts columns)."""
    B, _, H, W = shape
    return cp.fwd_plan(sms, blocks_per_sm, tile_h, tile_w, (B, 1, H, W))


def _check(x, w1, b1, w2, b2) -> None:
    cp._check(x, w1, b1)
    cp._check(x, w2, b2)
    if b1 is None or b2 is None:
        raise ValueError("conv3d64_pair needs both biases")


def _counts(x: torch.Tensor) -> PairCounts:
    return pick(x, counts, ahead_counts)


def conv3d64_pair_forward(x, w1, b1, w2, b2, slope: float = SLOPE,
                          with_mid: bool = False):
    """The fused forward without autograd: ``y``, or ``(y, z)`` with
    ``with_mid``."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        _counts(x).plain_calls += 1
        return conv3d64_pair_plain(x, w1, b1, w2, b2, slope, with_mid)
    w1, b1, w2, b2 = (cp.as_compute(t, x.dtype) for t in (w1, b1, w2, b2))
    B, T, H, W, _ = x.shape
    y = torch.empty_like(x)
    z = torch.empty_like(x) if with_mid else None
    if x.numel() == 0:
        return (y, z) if with_mid else y
    cp._check_launch([x, w1, b1, w2, b2, y] + ([z] if with_mid else []),
                     B, 1)
    grid = ()
    if x.dtype == torch.bfloat16:
        cfg = kernel_config(x.dtype, x.device.index)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = pair_plan(sms, cfg["blocks_per_sm"], cfg["tile_h"],
                         cfg["tile_w"], (B, T, H, W))
        if plan.ntiles >= 2 ** 31:
            raise ValueError(f"too many tile columns for one launch: "
                             f"{plan.ntiles}")
        grid = (plan.grid,)
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f"conv3d64_pair_{cp._suffix(x.dtype)}")(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), z.data_ptr() if with_mid else None,
            B, T, H, W, float(slope), *grid, cp._stream(x.device))
    cp._raise_on(err, "conv3d64_pair")
    if x.dtype == torch.bfloat16:
        _counts(x).bf16_launches += 1
    else:
        _counts(x).launches += 1
    return (y, z) if with_mid else y


def conv3d64_pair_backward(x, z, y, w1, w2, dy, needs=(True,) * 5,
                           plain: bool = False):
    """``(dx, dw1, db1, dw2, db2)`` of the pair from the forward's x, z and
    y (``conv3d_fuse.py:315-345``); a gradient ``needs`` does not ask for
    is ``None``.  dx has x's dtype, the others are f32; in bf16 dw1 and dw2
    are rounded to bf16 as the JAX package's correlation rounds them.  The
    LeakyReLU masks come from y and z themselves, so a reference built
    with ``plain=True`` (the plain versions, on any device) differs from
    the kernels only in summation order: a mask taken from another forward
    would flip wherever a pre-activation rounds to the other side of
    zero."""
    if plain:
        def dx_of(d, w):
            return cp.conv3d64_plain(d, cp.flip_swap(w))
        dw_of = cp.conv3d64_dw_plain
    else:
        dx_of, dw_of = cp.conv3d64_dx, cp.conv3d64_dw

    def dw_rounded(inp, d):
        return dw_of(inp, d).to(x.dtype).float()

    need_x, need_w1, need_b1, need_w2, need_b2 = needs
    d_pre2 = cp._lrelu_grad(cp.as_compute(dy, x.dtype), y, SLOPE)
    dx = dw1 = db1 = dw2 = db2 = None
    if need_w2:
        dw2 = dw_rounded(z, d_pre2)
    if need_b2:
        db2 = d_pre2.float().sum(dim=(0, 1, 2, 3))
    if need_x or need_w1 or need_b1:
        d_pre1 = cp._lrelu_grad(dx_of(d_pre2, w2), z, SLOPE)
        if need_x:
            dx = dx_of(d_pre1, w1)
        if need_w1:
            dw1 = dw_rounded(x, d_pre1)
        if need_b1:
            db1 = d_pre1.float().sum(dim=(0, 1, 2, 3))
    return dx, dw1, db1, dw2, db2


class Conv3d64PairFunction(torch.autograd.Function):
    """The fused pair with its backward on K1's dx and dw kernels;
    gradients not asked for are skipped."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, z = conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
        ctx.save_for_backward(x, z, y, w1, w2)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, z, y, w1, w2 = ctx.saved_tensors
        return conv3d64_pair_backward(x, z, y, w1, w2, dy.contiguous(),
                                      ctx.needs_input_grad)


def conv3d64_pair(x, w1, b1, w2, b2):
    """``lrelu(conv(lrelu(conv(x, w1) + b1), w2) + b2)``, slope 0.2,
    differentiable once.  The intermediate is written out only when a
    gradient will need it."""
    _check(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return Conv3d64PairFunction.apply(x, w1, b1, w2, b2)
    return conv3d64_pair_forward(x, w1, b1, w2, b2)
