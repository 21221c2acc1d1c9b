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

``conv3d64`` is differentiable through ``Conv3d64Function`` (marked
``once_differentiable``: the WGAN-GP's double backprop runs the stock
critic, as in the JAX package, and a second-order use raises).

On the card all three are bound by f32 operations: 2*27*64*64 FLOP per
voxel against 512 bytes read and written, far above the H100's ratio of
f32 FLOPs to HBM bytes.  Both kernels keep their operands in shared memory
and their accumulators in registers, and run on the CUDA cores in f32.
Moving the products onto the tensor cores (``wgmma``, bf16) is later work
(ROADMAP).

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
from torch.autograd.function import once_differentiable

__all__ = ["conv3d64", "conv3d64_plain", "conv3d64_dw", "conv3d64_dw_plain",
           "conv3d64_dx", "flip_swap", "Conv3d64Function", "counts",
           "KernelCounts", "kernel_config", "SOURCE", "DW_SOURCE",
           "REPLACES", "DX_REPLACES", "DW_REPLACES"]

SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_pack.cu"
DW_SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_dw.cu"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:182"
DX_REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:430"
DW_REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:307"
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y (T) and gridDim.z (B)
_DW_TILE_W = 64       # W pixels per row tile of the dw kernel (conv3d_dw.cu)
_DW_BLOCKS_PER_SM = 3  # its __launch_bounds__ minimum


@dataclasses.dataclass
class KernelCounts:
    """Launches of each K1 kernel, and calls served by a plain version
    (CPU tensors)."""

    fwd_launches: int = 0
    dx_launches: int = 0
    dw_launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.fwd_launches = self.dx_launches = self.dw_launches = 0
        self.plain_calls = 0


counts = KernelCounts()


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' references on the card
# ---------------------------------------------------------------------------

def conv3d64_plain(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   neg_slope: Optional[float] = None) -> torch.Tensor:
    """The forward as 27 shifted-tap products over a zero-padded input, in
    f32."""
    B, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    y = torch.zeros((B, T, H, W, w.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                y = y + torch.matmul(xp[:, dt:dt + T, dh:dh + H, dw:dw + W],
                                     wf[dt, dh, dw])
    if b is not None:
        y = y + b.float()
    if neg_slope is not None:
        y = torch.where(y >= 0, y, neg_slope * y)
    return y.to(x.dtype)


def conv3d64_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient as 27 tap products ``x_shift^T @ dy`` in f32."""
    B, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    dyf = dy.float().reshape(-1, dy.shape[-1])
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
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors must share a device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"the conv kernels take float32 only, got {t.dtype} (the "
                f"bf16 variant is a ROADMAP item)")
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare the forward's C interface."""
    from ._build import load_library
    lib = load_library("conv3d_pack")
    lib.conv3d64_fwd_f32.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 5
                                     + [ctypes.c_float, ctypes.c_void_p])
    lib.conv3d64_fwd_f32.restype = ctypes.c_int
    lib.conv3d64_fwd_f32_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.conv3d64_fwd_f32_config.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _dw_lib() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library("conv3d_dw")
    lib.conv3d64_dw_f32.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.conv3d64_dw_f32.restype = ctypes.c_int
    return lib


def kernel_config() -> dict:
    """Dynamic shared memory and threads of one forward block (builds the
    kernel if needed)."""
    smem, threads = ctypes.c_int(), ctypes.c_int()
    _lib().conv3d64_fwd_f32_config(ctypes.byref(smem), ctypes.byref(threads))
    return {"smem_bytes": smem.value, "threads": threads.value}


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             neg_slope: Optional[float], kind: str) -> torch.Tensor:
    """One forward conv: the plain version on the CPU, else the kernel,
    counted as ``kind`` ("fwd" or "dx")."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return conv3d64_plain(x, w, b, neg_slope)
    B, T, H, W, _ = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _check_launch((x, w, y), B, T)
    with torch.cuda.device(x.device):
        err = _lib().conv3d64_fwd_f32(
            x.data_ptr(), w.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(),
            B, T, H, W, int(neg_slope is not None), float(neg_slope or 0.0),
            _stream(x.device))
    _raise_on(err, "conv3d64")
    if kind == "dx":
        counts.dx_launches += 1
    else:
        counts.fwd_launches += 1
    return y


def conv3d64_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the conv for the cotangent ``dy`` (of the
    pre-activation): the forward on ``flip_swap(w)``, no bias."""
    _check(dy, w, None)
    return _forward(dy, flip_swap(w), None, None, "dx")


def _dw_chunks(B: int, T: int, H: int, W: int, device) -> int:
    """Voxel chunks of the dw kernel: one wave of 9 tap-pair blocks per
    chunk across the card's SMs, never more chunks than row tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = B * T * H * -(-W // _DW_TILE_W)
    return max(1, min(tiles, _DW_BLOCKS_PER_SM * sms // 9))


def conv3d64_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``(3,3,3,64,64)`` THWIO of the conv for input ``x``
    and cotangent ``dy`` (both ``(B,T,H,W,64)``).

    On the card: per-chunk partial sums into a scratch buffer, summed in a
    second pass in a fixed order, so the result is the same from run to
    run (no atomics)."""
    if x.shape != dy.shape or x.dim() != 5 or x.shape[-1] != 64:
        raise ValueError(f"x and dy must both be (B,T,H,W,64), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    _check_tensors([x, dy])
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return conv3d64_dw_plain(x, dy)
    B, T, H, W, _ = x.shape
    dw = torch.empty((3, 3, 3, 64, 64), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    nchunk = _dw_chunks(B, T, H, W, x.device)
    # freed on return while the kernel may still run: safe, the caching
    # allocator hands it out again only to work queued after it on this
    # stream (the same holds for the flip_swap(w) copy behind dx)
    partial = torch.empty((nchunk, dw.numel()), dtype=torch.float32,
                          device=x.device)
    _check_launch((x, dy, partial, dw), 1, 1)
    with torch.cuda.device(x.device):
        err = _dw_lib().conv3d64_dw_f32(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            B, T, H, W, nchunk, _stream(x.device))
    _raise_on(err, "conv3d64_dw")
    counts.dw_launches += 1
    return dw


def _lrelu_grad(dy: torch.Tensor, y: torch.Tensor, slope: float):
    """LeakyReLU is sign-preserving: its mask comes from the output."""
    return torch.where(y >= 0, dy, slope * dy)


class Conv3d64Function(torch.autograd.Function):
    """``conv3d64`` with its gradients on the kernels: dx on the forward
    kernel with ``flip_swap(w)``, dw on the dw kernel, db a plain sum
    (``conv3d_pack.py:414-447``).  Gradients not asked for are skipped."""

    @staticmethod
    def forward(ctx, x, w, b, neg_slope):
        y = _forward(x, w, b, neg_slope, "fwd")
        ctx.neg_slope = neg_slope
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, y if neg_slope is not None else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.neg_slope is not None:
            dy = _lrelu_grad(dy, y, ctx.neg_slope)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = conv3d64_dx(dy, w) if need_x else None
        dw = conv3d64_dw(x, dy) if need_w else None
        db = dy.sum(dim=(0, 1, 2, 3)) if need_b and ctx.has_bias else None
        return dx, dw, db, None


def conv3d64(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None,
             neg_slope: Optional[float] = None) -> torch.Tensor:
    """3x3x3 SAME conv + bias (+ LeakyReLU) for x ``(B,T,H,W,64)``,
    differentiable once.

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    on the current stream.  Anything the kernels do not take raises."""
    _check(x, w, b)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return Conv3d64Function.apply(x, w, b, neg_slope)
    return _forward(x, w, b, neg_slope, "fwd")
