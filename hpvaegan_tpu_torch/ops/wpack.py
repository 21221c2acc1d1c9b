"""Width-packed convolution (port of ``hpvaegan_tpu/ops/wpack.py:48-136``):
adjacent W pixels folded into channels, so that a conv sees both channel
dimensions doubled at the cost of structurally zero kernel blocks (1.33x
the FLOPs of the unpacked conv).  An execution path, not a model change:
the packed conv reads the unpacked conv's weights and computes the same
function up to the order of its f32 sums.

The port is channels-first: activations are NCDHW (NCHW in 2D), kernels
torch's ``(O, I, *k)``.  The two representations of the JAX module, with
W the last axis:

* ``Q(x)``: ``x`` zero-padded by (1, 1) along W, then pairs folded:
  packed column ``q`` holds ``(x_ext[2q], x_ext[2q + 1])`` as the channel
  blocks ``[0:C]`` / ``[C:2C]``; width ``(W + 2) / 2``, W even;
* ``P(y)``: unpadded pairs, column ``m = (y[2m], y[2m + 1])``; width
  ``W / 2``.

A packed conv maps ``Q(x)`` to ``P(y)`` with a VALID 2-tap kernel along
packed W; T and H keep their symmetric SAME padding.

In the JAX package's NTHWC a fold is a free reshape.  In NCDHW it is one
too when the tensor lies in ``channels_last_3d`` (``channels_last`` in
2D) memory, whose physical order is NTHWC, as the port's activations do
on the card (``ops/noise.py``, ``ops/resize.py``, cuDNN's outputs): there
``unpack_p`` is a view, and ``qpack`` and ``rephase`` are one copy each
(the W padding).  Other layouts pay a copy more.

Under a (data, spatial) mesh a packed conv's input is this rank's H
block: it takes the H halo (``ops/kernels/conv3d_spmd.halo``) and no zero
padding along H, as ``models/blocks._stock_conv`` does, so the packed
convs add no collective of their own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels.conv3d_spmd import halo

__all__ = [
    "can_wpack",
    "qpack",
    "unpack_p",
    "rephase",
    "pack_kernel",
    "pack_bias",
    "conv_packed",
]


def can_wpack(x_shape, min_w: int = 64) -> bool:
    """The packed path applies when W (the last axis) is even and at
    least ``min_w``."""
    w = x_shape[-1]
    return w % 2 == 0 and w >= min_w


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCDHW (NCHW) -> its NTHWC (NHWC) view."""
    return x.permute(0, *range(2, x.dim()), 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """NTHWC (NHWC) -> its NCDHW (NCHW) view."""
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def qpack(x: torch.Tensor) -> torch.Tensor:
    """``(N, C, ..., W)`` -> Q-rep ``(N, 2C, ..., (W + 2) / 2)``.  W must
    be even."""
    w, c = x.shape[-1], x.shape[1]
    assert w % 2 == 0, f"wpack needs even W, got {w}"
    t = F.pad(_nhwc(x), (0, 0, 1, 1))
    return _nchw(t.reshape(*t.shape[:-2], (w + 2) // 2, 2 * c))


def unpack_p(y: torch.Tensor) -> torch.Tensor:
    """P-rep ``(N, 2C, ..., M)`` -> ``(N, C, ..., 2M)``."""
    m, c = y.shape[-1], y.shape[1] // 2
    t = _nhwc(y)
    return _nchw(t.reshape(*t.shape[:-2], 2 * m, c))


def rephase(p: torch.Tensor) -> torch.Tensor:
    """P-rep of ``y`` -> Q-rep of ``y`` (the (1, 1) W zero padding put
    back): ``Q(y)[q] = (P[q - 1]``'s second half, ``P[q]``'s first half),
    zeros at the ends.  The JAX module shifts and swaps the halves; here
    the fold is undone as a view and redone with the padding, one copy
    either way, the same values."""
    return qpack(unpack_p(p))


def pack_kernel(k: torch.Tensor) -> torch.Tensor:
    """``(Co, Ci, kt, kh, 3)`` [``(Co, Ci, kh, 3)`` in 2D] -> the packed
    kernel ``(2Co, 2Ci, kt, kh, 2)`` mapping Q to P.

    With ``x_ext = pad(x, (1, 1))`` and ``y[w] = sum_dw K[dw] x_ext[w +
    dw]``, packed output column ``w'`` holds ``(y[2w'], y[2w' + 1])`` from
    the packed input taps ``q`` in ``{w', w' + 1}``:

      p=0: dw=0 -> (q0, pin0), dw=1 -> (q0, pin1), dw=2 -> (q1, pin0)
      p=1: dw=0 -> (q0, pin1), dw=1 -> (q1, pin0), dw=2 -> (q1, pin1)

    Channel blocks as the JAX layout: output ``[p, co]``, input ``[pin,
    ci]``; 2 of the 8 blocks are zero."""
    assert k.shape[-1] == 3, f"wpack supports ker_size 3 along W, got " \
                             f"{tuple(k.shape)}"
    k0, k1, k2 = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(k0)
    # rows: the output half p; columns: the input half pin
    tap0 = torch.cat([torch.cat([k0, k1], 1), torch.cat([zeros, k0], 1)], 0)
    tap1 = torch.cat([torch.cat([k2, zeros], 1), torch.cat([k1, k2], 1)], 0)
    return torch.stack([tap0, tap1], -1)


def pack_bias(b: torch.Tensor) -> torch.Tensor:
    """``(Co,)`` -> ``(2Co,)``: the output blocks ``[p=0 | p=1]`` of the
    same channels."""
    return torch.cat([b, b])


def conv_packed(xq: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None,
                mesh=None) -> torch.Tensor:
    """Q-rep input and the *unpacked* kernel ``(Co, Ci, ..., 3)`` -> P-rep
    output, on a stock conv.

    T and H get symmetric SAME padding for their kernel extent; packed W
    is VALID over its two taps.  ``dtype`` (None: f32): the compute
    dtype, as ``models/blocks._stock_conv`` takes it (flax's
    ``nn.Conv(dtype=...)``): operands cast to it, the product rounded to
    it and the bias added in it.  ``mesh``: ``xq`` is this rank's H block
    (see the module's docstring)."""
    kq = pack_kernel(kernel)
    nd = kq.dim() - 2                 # spatial axes, packed W included
    pads = [s // 2 for s in kq.shape[2:-1]] + [0]
    if mesh is not None and mesh.n_spatial > 1:
        xq = halo(xq, mesh, nd, pads[-2])   # H: axis nd of NCDHW / NCHW
        pads[-2] = 0
    conv = F.conv3d if nd == 3 else F.conv2d
    if dtype is None:
        return conv(xq, kq, None if bias is None else pack_bias(bias), 1,
                    tuple(pads))
    y = conv(xq.to(dtype), kq.to(dtype), None, 1, tuple(pads))
    if bias is None:
        return y
    return y + pack_bias(bias).to(dtype).reshape(-1, *(1,) * nd)
