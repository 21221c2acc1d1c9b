"""K1 forward: the 3x3x3 SAME conv with 64 -> 64 channels, as a CUDA kernel.

Replaces ``conv3d64_pallas`` (``hpvaegan_tpu/ops/pallas/conv3d_pack.py:182``),
the TPU kernel that the JAX package runs for every 64 -> 64 ``ConvBlock``
conv of a generator ``Stage`` under ``--pconv-all``.  Same function and
layouts: x ``(B,T,H,W,64)`` NTHWC, w ``(3,3,3,64,64)`` THWIO, b ``(64,)``,
``y = conv3d(x, w, SAME zeros, stride 1) + b`` with an optional fused
LeakyReLU, f32 accumulation, output in x's dtype.

On the card this is bound by f32 operations: 27*64*64 FMAs per output
voxel against 512 bytes read and written, far above the H100's ratio of
f32 FLOPs to HBM bytes.  The kernel (``csrc/conv3d_pack.cu``) therefore
keeps the input slab and the weight taps in shared memory and 64
accumulators per thread in registers, so each loaded value feeds many
FMAs; it runs on the CUDA cores in f32.  Moving the product onto the
tensor cores (``wgmma``, bf16) is later work (ROADMAP).

Routing gate: the port routes a conv here when it is 3D, 3x3x3, stride 1,
padding 1 with zeros and 64 -> 64 (``hpvaegan_tpu/models/blocks.py:164-166``).
The JAX package's other two gates are TPU rules and are dropped:
``pconv_wins`` (W % 256 == 0, the 128-lane packing) and the VMEM budget
in ``pconv_ok``; this kernel takes any B, T, H, W.  A gate for the H100
waits for measurements.

On a CPU tensor the wrapper runs ``conv3d64_plain``; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["conv3d64", "conv3d64_plain", "counts", "KernelCounts",
           "kernel_config", "SOURCE", "REPLACES"]

SOURCE = "hpvaegan_tpu_torch/csrc/conv3d_pack.cu"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_pack.py:182"
_LIB_NAME = "conv3d_pack"
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y (T) and gridDim.z (B)


@dataclasses.dataclass
class KernelCounts:
    """``launches``: kernel launches; ``plain_calls``: calls served by the
    plain version (CPU tensors)."""

    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


counts = KernelCounts()


def conv3d64_plain(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   neg_slope: Optional[float] = None) -> torch.Tensor:
    """The same function as 27 shifted-tap products over a zero-padded
    input, in f32.  The CPU path of ``conv3d64`` and the kernel's reference
    on the card."""
    B, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    y = torch.zeros((B, T, H, W, w.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                y += torch.matmul(xp[:, dt:dt + T, dh:dh + H, dw:dw + W],
                                  wf[dt, dh, dw])
    if b is not None:
        y += b.float()
    if neg_slope is not None:
        y = torch.where(y >= 0, y, neg_slope * y)
    return y.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    if x.dim() != 5 or x.shape[-1] != 64:
        raise ValueError(f"x must be (B,T,H,W,64), got {tuple(x.shape)}")
    if tuple(w.shape) != (3, 3, 3, 64, 64):
        raise ValueError(f"w must be (3,3,3,64,64), got {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (64,):
        raise ValueError(f"b must be (64,), got {tuple(b.shape)}")
    tensors = [x, w] + ([b] if b is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"x, w and b must share a device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"conv3d64 takes float32 only, got {t.dtype} (the bf16 "
                f"variant is a ROADMAP item)")
        if not t.is_contiguous():
            raise ValueError("x, w and b must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare the C interface."""
    from ._build import load_library
    lib = load_library(_LIB_NAME)
    lib.conv3d64_fwd_f32.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 5
                                     + [ctypes.c_float, ctypes.c_void_p])
    lib.conv3d64_fwd_f32.restype = ctypes.c_int
    lib.conv3d64_fwd_f32_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.conv3d64_fwd_f32_config.restype = ctypes.c_int
    return lib


def kernel_config() -> dict:
    """Dynamic shared memory and threads of one block (builds the
    kernel if needed)."""
    smem, threads = ctypes.c_int(), ctypes.c_int()
    _lib().conv3d64_fwd_f32_config(ctypes.byref(smem), ctypes.byref(threads))
    return {"smem_bytes": smem.value, "threads": threads.value}


def conv3d64(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None,
             neg_slope: Optional[float] = None) -> torch.Tensor:
    """3x3x3 SAME conv + bias (+ LeakyReLU) for x ``(B,T,H,W,64)``.

    CPU tensors run ``conv3d64_plain``; CUDA tensors launch the kernel on
    the current stream.  Anything the kernel does not take raises."""
    _check(x, w, b)
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return conv3d64_plain(x, w, b, neg_slope)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d64 runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    B, T, H, W, _ = x.shape
    if B > _GRID_YZ_MAX or T > _GRID_YZ_MAX:
        raise ValueError(f"B and T must be <= {_GRID_YZ_MAX}, got {B}, {T}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    for t in (x, w, y):
        if t.data_ptr() % 16:
            raise ValueError("conv3d64 needs 16-byte aligned tensors")
    fn = _lib().conv3d64_fwd_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 b.data_ptr() if b is not None else None, y.data_ptr(),
                 B, T, H, W, int(neg_slope is not None),
                 float(neg_slope or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"conv3d64 kernel launch failed with CUDA error "
                           f"{err}")
    counts.launches += 1
    return y
