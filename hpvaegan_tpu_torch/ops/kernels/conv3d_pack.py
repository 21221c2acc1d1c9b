"""K1: the 3x3x3 SAME conv with 64 -> 64 channels, forward and gradients,
as CUDA kernels.

Replaces the TPU kernels behind ``conv3d64``
(``hpvaegan_tpu/ops/pallas/conv3d_pack.py:414-447``):

* forward: ``conv3d64_pallas`` (``:182``), the kernel the JAX package runs
  for every 64 -> 64 ``ConvBlock`` conv of a generator ``Stage`` under
  ``--pconv-all`` and for the critic's single-conv body blocks under
  ``--pconv``.  ``y = conv3d(x, w, SAME zeros, stride 1) + b`` with an
  optional fused LeakyReLU, x ``(B,T,H,W,64)`` NTHWC, w ``(3,3,3,64,64)``
  THWIO, b ``(64,)``, f32 accumulation (``csrc/conv3d_pack.cu``);
* input gradient: the same forward kernel on ``flip_swap(w)`` (taps
  flipped, in/out channels swapped), no bias (``:430-434``): no source of
  its own;
* weight gradient: ``conv3d64_dw_pallas`` (``:307``),
  ``dw[dt,dh,dw,ci,co] = sum_{b,t,h,w} x_pad[b,t+dt-1,h+dh-1,w+dw-1,ci]
  * dy[b,t,h,w,co]`` (``csrc/conv3d_dw.cu``);
* the bias gradient is a plain sum, as the JAX package computes it
  outside Pallas.

``conv3d64`` is differentiable any number of times, as the JAX rule is
(``conv3d_pack.py:388-447``): ``Conv3d64Function``'s backward computes dx
through ``conv3d64`` itself on ``flip_swap(w)`` and dw through
``Conv3d64DwFunction``, whose backward is again two K1 convs, so every
derivative of every order runs on these kernels.  A backward that will
not use dw or db skips it: the WGAN-GP's inner gradient, taken w.r.t.
the critic's input alone, asks the autograd engine whether it will run
the weight's and the bias's gradient edges (``_engine_runs``), which is a
fact of that one backward, so a step on another thread at the same time
keeps its weight gradients.

Two compute dtypes, as in the JAX package (``conv3d_pack.py:190-197,
315-320, 423-444``):

* f32: every operand f32, CUDA-core kernels.  Bound by f32 operations:
  2*27*64*64 FLOP per voxel against 512 bytes read and written.
* bf16 (``--bf16``): x bf16, w and b cast to bf16 here (the parameters
  stay f32), f32 accumulation, bias and LeakyReLU in f32, y rounded to
  bf16; dw takes bf16 x and dy (cast to x's dtype) and returns f32.  The
  forward and dw kernels run on the tensor cores (``wgmma`` fed by TMA
  loads, f32 accumulate), bound by the 989 TFLOP/s bf16 rate.  A bf16 tensor launches a bf16
  kernel: nothing is cast to f32 to reuse the f32 ones.

The dw launch is planned from the kernel's own report
(``dw_kernel_config``: blocks an SM from CUDA's occupancy API, grid
blocks a chunk, row-tile width) by the pure ``dw_plan``; the bf16
forward's persistent grid likewise (``kernel_config``, ``fwd_plan``).

Launches are counted per kernel and dtype (``counts``; the work of
``--compile-ahead`` beside the main path in ``ahead_counts``).

Routing gate: the port routes a conv here when it is 3D, 3x3x3, stride 1,
padding 1 with zeros and 64 -> 64 (``hpvaegan_tpu/models/blocks.py:164-166``).
The JAX package's other two gates are TPU rules and are dropped:
``pconv_wins`` (W % 256 == 0, the 128-lane packing) and the VMEM budget
in ``pconv_ok``; these kernels take any B, T, H, W.

On CPU tensors every entry point runs its plain version; on CUDA tensors
it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ._counting import pick

__all__ = ["conv3d64", "conv3d64_plain", "conv3d64_dw", "conv3d64_dw_plain",
           "conv3d64_dx", "flip_swap", "as_compute", "scalar_as",
           "Conv3d64Function", "Conv3d64DwFunction",
           "counts", "ahead_counts", "KernelCounts", "kernel_config", "dw_kernel_config",
           "DwPlan", "dw_plan", "FwdPlan", "fwd_plan", "SOURCE", "DW_SOURCE",
           "REPLACES", "DX_REPLACES", "DW_REPLACES"]

SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_pack.cu"
DW_SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_dw.cu"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:182"
DX_REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:430"
DW_REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:307"
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y (T) and gridDim.z (B)
_DW_TAPS = 27 * 64 * 64  # floats of one full dw (a chunk's partial sums)
_DW_CONFIG = ("threads", "smem_bytes", "blocks_per_sm", "blocks_per_chunk",
              "tile_w")
_FWD_CONFIG = {"f32": ("smem_bytes", "threads"),
               "bf16": ("smem_bytes", "threads", "blocks_per_sm", "tile_h",
                        "tile_w")}


@dataclasses.dataclass
class KernelCounts:
    """Launches of each K1 kernel per dtype, and calls served by a plain
    version (CPU tensors)."""

    fwd_launches: int = 0
    dx_launches: int = 0
    dw_launches: int = 0
    fwd_bf16_launches: int = 0
    dx_bf16_launches: int = 0
    dw_bf16_launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)

    def add(self, kind: str, dtype: torch.dtype) -> None:
        """One launch of ``kind`` ("fwd", "dx" or "dw") in ``dtype``."""
        name = f"{kind}_bf16_launches" if dtype == torch.bfloat16 \
            else f"{kind}_launches"
        setattr(self, name, getattr(self, name) + 1)


counts = KernelCounts()
# the launches of --compile-ahead's work beside the main path
# (``_counting.py``)
ahead_counts = KernelCounts()

_DTYPES = (torch.float32, torch.bfloat16)


def as_compute(t: Optional[torch.Tensor], dtype: torch.dtype):
    """``t`` rounded to the compute dtype (the JAX package's
    ``astype(x.dtype)`` of the weights, bias and cotangent)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' references on the card
# ---------------------------------------------------------------------------

def conv3d64_plain(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   neg_slope: Optional[float] = None) -> torch.Tensor:
    """The forward as 27 shifted-tap products over a zero-padded input:
    ``w`` and ``b`` rounded to x's dtype first, then f32 products and sums,
    bias and LeakyReLU in f32, the result rounded to x's dtype."""
    B, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = as_compute(w, x.dtype).float()
    y = torch.zeros((B, T, H, W, w.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                y = y + torch.matmul(xp[:, dt:dt + T, dh:dh + H, dw:dw + W],
                                     wf[dt, dh, dw])
    if b is not None:
        y = y + as_compute(b, x.dtype).float()
    if neg_slope is not None:
        y = torch.where(y >= 0, y, neg_slope * y)
    return y.to(x.dtype)


def conv3d64_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient as 27 tap products ``x_shift^T @ dy`` in f32,
    ``dy`` rounded to x's dtype first; f32 out."""
    B, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    dyf = as_compute(dy, x.dtype).float().reshape(-1, dy.shape[-1])
    taps = [xp[:, dt:dt + T, dh:dh + H, dw:dw + W].reshape(-1, C).T @ dyf
            for dt in range(3) for dh in range(3) for dw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, C, dy.shape[-1])


def flip_swap(w: torch.Tensor) -> torch.Tensor:
    """Kernel of the transposed (input-gradient) conv: taps flipped on all
    three spatial axes, in/out channels swapped
    (``conv3d_pack.py:403-406``)."""
    return w.flip((0, 1, 2)).transpose(3, 4).contiguous()


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    if x.dim() != 5 or x.shape[-1] != 64:
        raise ValueError(f"x must be (B,T,H,W,64), got {tuple(x.shape)}")
    if tuple(w.shape) != (3, 3, 3, 64, 64):
        raise ValueError(f"w must be (3,3,3,64,64), got {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (64,):
        raise ValueError(f"b must be (64,), got {tuple(b.shape)}")
    _check_tensors([x, w] + ([b] if b is not None else []))


def _check_tensors(tensors) -> None:
    """The first tensor sets the compute dtype (float32 or bfloat16); the
    others are float32 or that dtype."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"the conv kernels compute in float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors must share a device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype not in (torch.float32, dtype):
            raise NotImplementedError(
                f"a {dtype} conv takes float32 or {dtype} operands, got "
                f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the conv kernels take contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv kernels run on CUDA or CPU tensors, got "
                         f"{dev}")


def _check_launch(tensors, B: int, T: int) -> None:
    if B > _GRID_YZ_MAX or T > _GRID_YZ_MAX:
        raise ValueError(f"B and T must be <= {_GRID_YZ_MAX}, got {B}, {T}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the conv kernels need 16-byte aligned tensors")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")


def _suffix(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare the forward's C interface."""
    from ._build import load_library
    lib = load_library("conv3d_pack")
    for sfx in ("f32", "bf16"):
        fn = getattr(lib, f"conv3d64_fwd_{sfx}")
        # the bf16 instance also takes its persistent grid
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * (sfx == "bf16")
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cfg = getattr(lib, f"conv3d64_fwd_{sfx}_config")
        cfg.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(_FWD_CONFIG[sfx])
        cfg.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _dw_lib() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library("conv3d_dw")
    for sfx in ("f32", "bf16"):
        fn = getattr(lib, f"conv3d64_dw_{sfx}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cfg = getattr(lib, f"conv3d64_dw_{sfx}_config")
        cfg.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(_DW_CONFIG)
        cfg.restype = ctypes.c_int
    return lib


def kernel_config(dtype: torch.dtype = torch.float32,
                  device: Optional[int] = None) -> dict:
    """Dynamic shared memory and threads of one forward block in
    ``dtype``; for bf16 also blocks an SM on ``device`` (CUDA's occupancy
    API; the current device by default) and the output tile (rows,
    columns) of the persistent walk.  Builds the kernel if needed."""
    if device is None:
        device = torch.cuda.current_device()
    return _fwd_config(_suffix(dtype), device)


@functools.lru_cache(maxsize=None)
def _fwd_config(sfx: str, device: int) -> dict:
    vals = [ctypes.c_int() for _ in _FWD_CONFIG[sfx]]
    with torch.cuda.device(device):
        err = getattr(_lib(), f"conv3d64_fwd_{sfx}_config")(
            *(ctypes.byref(v) for v in vals))
    _raise_on(err, "conv3d64_fwd config")
    cfg = dict(zip(_FWD_CONFIG[sfx], (v.value for v in vals)))
    if cfg.get("blocks_per_sm", 1) < 1:
        raise RuntimeError(f"the {sfx} forward kernel fits no block on an "
                           f"SM: {cfg}")
    return cfg


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """A persistent bf16 forward launch: ``grid`` blocks walk the
    ``ntiles`` output tiles round-robin (block i takes tiles i, i + grid,
    ...), tile index ``((b * T + t) * tiles_h + row) * tiles_w + col``."""

    ntiles: int
    tiles_h: int
    tiles_w: int
    grid: int


def fwd_plan(sms: int, blocks_per_sm: int, tile_h: int, tile_w: int,
             shape) -> FwdPlan:
    """The persistent grid of a bf16 forward on a card of ``sms`` SMs for
    ``shape`` ``(B, T, H, W)``: one wave of resident blocks, never more
    blocks than tiles, at least one."""
    B, T, H, W = shape
    tiles_h, tiles_w = -(-H // tile_h), -(-W // tile_w)
    ntiles = B * T * tiles_h * tiles_w
    grid = max(1, min(ntiles, sms * blocks_per_sm))
    return FwdPlan(ntiles, tiles_h, tiles_w, grid)


def _counts(x: torch.Tensor) -> KernelCounts:
    return pick(x, counts, ahead_counts)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             neg_slope: Optional[float], kind: str) -> torch.Tensor:
    """One forward conv in x's dtype: the plain version on the CPU, else
    the kernel of that dtype, counted as ``kind`` ("fwd" or "dx")."""
    if x.device.type == "cpu":
        _counts(x).plain_calls += 1
        return conv3d64_plain(x, w, b, neg_slope)
    w, b = as_compute(w, x.dtype), as_compute(b, x.dtype)
    B, T, H, W, _ = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _check_launch((x, w, y) + ((b,) if b is not None else ()), B, T)
    grid = ()
    if x.dtype == torch.bfloat16:
        cfg = kernel_config(x.dtype, x.device.index)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = fwd_plan(sms, cfg["blocks_per_sm"], cfg["tile_h"],
                        cfg["tile_w"], (B, T, H, W))
        if plan.ntiles >= 2 ** 31:
            raise ValueError(f"too many output tiles for one launch: "
                             f"{plan.ntiles}")
        grid = (plan.grid,)
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f"conv3d64_fwd_{_suffix(x.dtype)}")(
            x.data_ptr(), w.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(),
            B, T, H, W, int(neg_slope is not None), float(neg_slope or 0.0),
            *grid, _stream(x.device))
    _raise_on(err, "conv3d64")
    _counts(x).add(kind, x.dtype)
    return y


def conv3d64_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the conv for the cotangent ``dy`` (of the
    pre-activation): the forward on ``flip_swap(w)``, no bias, in dy's
    dtype."""
    _check(dy, w, None)
    return _forward(dy, flip_swap(w), None, None, "dx")


def dw_kernel_config(dtype: torch.dtype = torch.float32,
                     device: Optional[int] = None) -> dict:
    """The dw kernel's launch plan in ``dtype`` on ``device`` (the current
    one by default): threads and dynamic shared memory of a block, blocks
    an SM (CUDA's occupancy API), grid blocks a chunk and W pixels a row
    tile.  Builds the kernel if needed."""
    if device is None:
        device = torch.cuda.current_device()
    return _dw_config(_suffix(dtype), device)


@functools.lru_cache(maxsize=None)
def _dw_config(sfx: str, device: int) -> dict:
    vals = [ctypes.c_int() for _ in _DW_CONFIG]
    with torch.cuda.device(device):
        err = getattr(_dw_lib(), f"conv3d64_dw_{sfx}_config")(
            *(ctypes.byref(v) for v in vals))
    _raise_on(err, "conv3d64_dw config")
    cfg = dict(zip(_DW_CONFIG, (v.value for v in vals)))
    if cfg["blocks_per_sm"] < 1:
        raise RuntimeError(f"the {sfx} dw kernel fits no block on an SM: "
                           f"{cfg}")
    return cfg


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """A dw launch: ``nchunk`` chunks of rows, a grid of
    ``(blocks_per_chunk, nchunk)`` blocks, and the scratch of one 27x64x64
    partial sum per chunk."""

    nchunk: int
    grid: tuple
    scratch_floats: int


def dw_plan(sms: int, blocks_per_sm: int, blocks_per_chunk: int,
            tile_w: int, shape) -> DwPlan:
    """The chunks of a dw launch on a card of ``sms`` SMs for ``shape``
    ``(B, T, H, W)``: one wave of ``blocks_per_chunk`` blocks a chunk, at
    least one chunk, never more chunks than row tiles of ``tile_w``
    pixels (nor than gridDim.y allows)."""
    B, T, H, W = shape
    tiles = B * T * H * -(-W // tile_w)
    nchunk = max(1, min(tiles, sms * blocks_per_sm // blocks_per_chunk,
                        _GRID_YZ_MAX))
    return DwPlan(nchunk, (blocks_per_chunk, nchunk), nchunk * _DW_TAPS)


def conv3d64_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``(3,3,3,64,64)`` THWIO, f32, of the conv for input
    ``x`` and cotangent ``dy`` (both ``(B,T,H,W,64)``; dy is rounded to
    x's dtype).

    On the card: per-chunk partial sums into a scratch buffer, summed in a
    second pass in a fixed order, so the result is the same from run to
    run (no atomics)."""
    if x.shape != dy.shape or x.dim() != 5 or x.shape[-1] != 64:
        raise ValueError(f"x and dy must both be (B,T,H,W,64), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    _check_tensors([x, dy])
    if x.device.type == "cpu":
        _counts(x).plain_calls += 1
        return conv3d64_dw_plain(x, dy)
    dy = as_compute(dy, x.dtype)
    B, T, H, W, _ = x.shape
    dw = torch.empty((3, 3, 3, 64, 64), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    cfg = dw_kernel_config(x.dtype, x.device.index)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = dw_plan(sms, cfg["blocks_per_sm"], cfg["blocks_per_chunk"],
                   cfg["tile_w"], (B, T, H, W))
    # freed on return while the kernel may still run: safe, the caching
    # allocator hands it out again only to work queued after it on this
    # stream (the same holds for the flip_swap(w) copy behind dx)
    partial = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    _check_launch((x, dy, partial, dw), 1, 1)
    with torch.cuda.device(x.device):
        err = getattr(_dw_lib(), f"conv3d64_dw_{_suffix(x.dtype)}")(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            B, T, H, W, plan.nchunk, _stream(x.device))
    _raise_on(err, "conv3d64_dw")
    _counts(x).add("dw", x.dtype)
    return dw


@functools.lru_cache(maxsize=None)
def scalar_as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX turns a Python scalar into the
    array's dtype before an op (``bf16(0.2) * dy`` in bf16), where torch
    would multiply by the f32 scalar and round once."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _lrelu_grad(dy: torch.Tensor, y: torch.Tensor, slope: float):
    """LeakyReLU is sign-preserving: its mask comes from the output."""
    return torch.where(y >= 0, dy, scalar_as(slope, dy.dtype) * dy)


def _engine_runs(edge) -> bool:
    """Will the backward now running use the gradient sent along
    ``edge`` (a ``next_functions`` entry)?  ``ctx.needs_input_grad`` is
    fixed when the graph is built, so a gradient taken w.r.t. the input
    alone (the WGAN-GP's inner ``autograd.grad``,
    ``losses.calc_gradient_penalty``) would otherwise launch a dw per
    conv for nothing.  The engine's record is a fact of the one
    backward, whatever other threads differentiate meanwhile (a flag
    held around the inner pass would be process-wide: the engine runs a
    CUDA backward on its own thread).  True outside a backward that asks
    for chosen inputs only, and where the engine cannot say (a leaf
    asked for by ``autograd.grad`` itself)."""
    node = edge[0]
    if node is None:
        return False
    try:
        return bool(torch._C._will_engine_execute_node(node))
    except RuntimeError:
        return True


def _differentiable(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _conv(x, w, b, neg_slope, kind: str):
    """The forward kernel counted as ``kind``, through the Function when
    a gradient may be taken."""
    if _differentiable(x, w, b):
        return Conv3d64Function.apply(x, w, b, neg_slope, kind)
    return _forward(x, w, b, neg_slope, kind)


def _dw(x, dy):
    if _differentiable(x, dy):
        return Conv3d64DwFunction.apply(x, dy)
    return conv3d64_dw(x, dy)


class Conv3d64Function(torch.autograd.Function):
    """``conv3d64`` with its gradients on the kernels (``conv3d_pack.py:
    414-447``): dx is ``conv3d64`` again on ``flip_swap(w)`` (counted as a
    dx launch), dw is ``Conv3d64DwFunction``, db a plain f32 sum, all of
    them differentiable, so the backward can itself be differentiated.
    The cotangent is rounded to x's dtype first; dx comes back in the
    cotangent's dtype, dw and db in the parameters'.  Gradients not asked
    for are skipped, and so are dw and db where this backward will not
    use them (``_engine_runs``: the WGAN-GP's inner gradient).
    An undefined cotangent stays undefined (no launch): the outer pass of
    the WGAN-GP sends one into every forward node of the critic (a stock
    conv's double backward has no input gradient when the inner pass took
    no weight gradient), and materialised zeros would cost a dx and a dw
    each."""

    @staticmethod
    def forward(ctx, x, w, b, neg_slope, kind):
        y = _forward(x, w, b, neg_slope, kind)
        ctx.neg_slope = neg_slope
        ctx.b_dtype = b.dtype if b is not None else None
        ctx.save_for_backward(x, w, y if neg_slope is not None else None)
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None, None
        x, w, y = ctx.saved_tensors
        out_dtype = dy.dtype
        dy = as_compute(dy.contiguous(), x.dtype)
        if ctx.neg_slope is not None:
            dy = _lrelu_grad(dy, y, ctx.neg_slope)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        edges = ctx.next_functions
        need_w = need_w and _engine_runs(edges[1])
        need_b = need_b and _engine_runs(edges[2])
        dx = (_conv(dy, flip_swap(w), None, None, "dx").to(out_dtype)
              if need_x else None)
        dw = _dw(x, dy).to(w.dtype) if need_w else None
        db = (dy.float().sum(dim=(0, 1, 2, 3)).to(ctx.b_dtype)
              if need_b and ctx.b_dtype is not None else None)
        return dx, dw, db, None, None


class Conv3d64DwFunction(torch.autograd.Function):
    """``conv3d64_dw`` made differentiable, the counterpart of the JAX
    package's ``_dw`` (``conv3d_pack.py:387-400``).  dw is bilinear in
    (x, dy), and its reverse-mode rule for a cotangent g ``(3,3,3,64,64)``
    is the transpose of ``_dw_jvp``, two K1 convs: grad x =
    ``conv3d64(dy, flip_swap(g))`` (sum over k, co of
    ``g[k,ci,co] dy[q-k+1,co]``), counted as dx, and grad dy =
    ``conv3d64(x, g)`` (sum over k, ci of ``g[k,ci,co] x_pad[p+k-1,ci]``),
    counted as fwd; g is rounded to the compute dtype, grad x comes back in
    x's dtype and grad dy in dy's.  An undefined g launches nothing."""

    @staticmethod
    def forward(ctx, x, dy):
        ctx.dy_dtype = dy.dtype
        dy = as_compute(dy, x.dtype)
        ctx.save_for_backward(x, dy)
        ctx.set_materialize_grads(False)
        return conv3d64_dw(x, dy)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        x, dy = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_dy = ctx.needs_input_grad
        gx = (_conv(dy, flip_swap(g), None, None, "dx").to(x.dtype)
              if need_x else None)
        gdy = (_conv(x, g, None, None, "fwd").to(ctx.dy_dtype)
               if need_dy else None)
        return gx, gdy


def conv3d64(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None,
             neg_slope: Optional[float] = None) -> torch.Tensor:
    """3x3x3 SAME conv + bias (+ LeakyReLU) for x ``(B,T,H,W,64)``,
    differentiable any number of times, computed in x's dtype (float32,
    or bfloat16 with ``w`` and ``b`` rounded to it and f32 accumulation).

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    on the current stream, for every derivative too.  Anything the
    kernels do not take raises."""
    _check(x, w, b)
    return _conv(x, w, b, neg_slope, "fwd")
