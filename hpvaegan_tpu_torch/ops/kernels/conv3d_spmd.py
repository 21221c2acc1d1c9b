"""K4: the K1 conv over a ``(data, spatial)`` mesh of ranks, with the H
halo exchanged between ring neighbours (port of
``hpvaegan_tpu/ops/pallas/conv3d_spmd.py:109-144``).

K4 has no kernel body of its own: it runs the port's K1 CUDA kernels
(``conv3d_pack.conv3d64``: ``csrc/conv3d_pack.cu``, ``csrc/conv3d_dw.cu``)
on each rank's block, as the JAX package runs its Pallas K1 inside a
``shard_map``:

1. each rank sends its last H row to the next rank of its spatial ring
   and its first row to the previous one; the two ring ends receive
   zeros, which is the global SAME zero padding (``halo``);
2. ``[halo_up, x, halo_dn]`` goes through K1 (SAME padding, with its
   bias / LeakyReLU epilogue) on the block of ``h + 2`` rows;
3. the interior rows ``[:, :, 1:-1]`` are kept: each saw only real
   neighbours, so they equal the global conv's rows.

With one spatial rank it is K1 on the rank's batch rows.  Its gradient is
K1's own (dx on the kernel with ``flip_swap(w)``, dw on the dw kernel, on
the haloed block) plus the halo's adjoint, which sends each received
row's cotangent back to its sender and adds it to the sender's edge row
(``shard_map``'s transpose of ``ppermute`` in the JAX package).  The
replicated weight's cotangent is NOT summed here: each rank's dw is its
share, and the training step sums every parameter's gradient over the
mesh once (``train/steps.py``), as ``shard_map``'s transpose inserts one
``psum``.

``halo`` is an autograd Function whose backward is the adjoint exchange,
itself a Function whose backward is the exchange again: it is
differentiable any number of times, which the WGAN-GP's double backprop
through the stock critic's haloed convs needs (``models/blocks.py``).
K1's Functions are too, so K4 is differentiable any number of times, as
the JAX package's K4 is: every derivative runs K1's kernels on the
haloed block and the halo's exchanges around them.

Gate (``pconv_spmd_ok``): the JAX package takes the composition only for
even shards whose haloed block passes ``pconv_ok``, and sends the rest to
the lax conv, which XLA partitions itself.  The port's route is fixed when
a conv is built (``models/blocks.py`` ``k1_geometry``), and K1 takes any
block, so a kernel-routed conv under a mesh always runs K4; uneven H
blocks take the same path (the numbers are the same).  What the gate
still decides is whether a whole shape can be run on the mesh at all:
5-D, 64 channels, a batch that splits over the data axis and at least
one H row a rank.  The trainer checks every stage's shape with it before
a scale starts (``train/trainer.py``).

Launches are counted in ``counts`` where K4 launches K1's forward (a CUDA
block), by dtype, once a composition; CPU blocks take K1's plain version
through the same composition and count as ``plain_calls``.  The
gradients' K1 launches re-enter ``conv3d64``, not K4, and count in K1's
own ``conv3d_pack.counts`` only.  ``conv3d64_spmd_plain`` is the
same composition around ``conv3d64_plain``, for the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...parallel import distributed as _dist
from ._counting import pick
from .conv3d_pack import conv3d64, conv3d64_plain

__all__ = ["conv3d64_spmd", "conv3d64_spmd_plain", "pconv_spmd_ok", "halo",
           "counts", "ahead_counts", "SpmdCounts", "REPLACES", "SOURCE"]

SOURCE = "hpvaegan_tpu_torch/ops/kernels/conv3d_spmd.py"
REPLACES = "hpvaegan_tpu/ops/pallas/conv3d_spmd.py:109"


@dataclasses.dataclass
class SpmdCounts:
    """K4 compositions whose K1 forward was a kernel launch (f32, bf16),
    and those served by K1's plain version (CPU blocks)."""

    launches: int = 0
    bf16_launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = self.bf16_launches = self.plain_calls = 0


counts = SpmdCounts()
ahead_counts = SpmdCounts()   # --compile-ahead's (``_counting.py``)


def _exchange(x: torch.Tensor, mesh, dim: int, width: int) -> torch.Tensor:
    """``[rows from the previous rank, x, rows from the next]`` along
    ``dim``; zeros at the ring's ends."""
    prev, nxt = mesh.neighbours()
    first = x.narrow(dim, 0, width)
    last = x.narrow(dim, x.shape[dim] - width, width)
    up, dn = torch.zeros_like(first), torch.zeros_like(last)
    sends, recvs = [], []
    if prev is not None:
        sends.append((first, prev))
        recvs.append((up, prev))
    if nxt is not None:
        sends.append((last, nxt))
        recvs.append((dn, nxt))
    _dist.send_recv(sends, recvs)
    return torch.cat([up, x, dn], dim)


def _exchange_adjoint(g: torch.Tensor, mesh, dim: int, width: int
                      ) -> torch.Tensor:
    """The adjoint of ``_exchange``: the interior of ``g``, plus the
    cotangents of this rank's rows that the neighbours used as halo; the
    halo rows' own cotangents go back to their senders (dropped at the
    ring's ends, whose halo was zeros)."""
    prev, nxt = mesh.neighbours()
    h = g.shape[dim] - 2 * width
    out = g.narrow(dim, width, h).clone()
    from_prev = torch.zeros_like(g.narrow(dim, 0, width))
    from_next = torch.zeros_like(from_prev)
    sends, recvs = [], []
    if prev is not None:
        sends.append((g.narrow(dim, 0, width), prev))
        recvs.append((from_prev, prev))
    if nxt is not None:
        sends.append((g.narrow(dim, width + h, width), nxt))
        recvs.append((from_next, nxt))
    _dist.send_recv(sends, recvs)
    out.narrow(dim, 0, width).add_(from_prev)
    out.narrow(dim, h - width, width).add_(from_next)
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, width):
        ctx.args = (mesh, dim, width)
        return _exchange(x, mesh, dim, width)

    @staticmethod
    def backward(ctx, g):
        return (_HaloAdjoint.apply(g.contiguous(), *ctx.args), None, None,
                None)


class _HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mesh, dim, width):
        ctx.args = (mesh, dim, width)
        return _exchange_adjoint(g, mesh, dim, width)

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg.contiguous(), *ctx.args), None, None, None


def halo(x: torch.Tensor, mesh, dim: int, width: int = 1) -> torch.Tensor:
    """``x`` (this rank's block) with ``width`` rows of each spatial
    neighbour's block on either side along ``dim``, zeros at the ring's
    ends; differentiable any number of times.  Every rank of the mesh
    must call it, in the same order."""
    if x.shape[dim] < width:
        raise ValueError(f"a block of {x.shape[dim]} rows cannot lend a "
                         f"halo of {width}")
    return _Halo.apply(x.contiguous(), mesh, dim, width)


def pconv_spmd_ok(x_shape, w_shape, mesh, dtype=None) -> bool:
    """Can K4 run the conv of a whole ``x_shape`` (B,T,H,W,C) with
    ``w_shape`` on ``mesh``?  (``conv3d_spmd.py:72-83``; the module
    docstring says what changed.)  ``dtype`` is accepted for the JAX
    signature; both compute dtypes run."""
    if len(x_shape) != 5 or tuple(w_shape) != (3, 3, 3, 64, 64):
        return False
    B, T, H, W, C = x_shape
    return C == 64 and B % mesh.n_data == 0 and H >= mesh.n_spatial


def _compose(conv, x, w, b, mesh, neg_slope):
    if mesh.n_spatial == 1:
        return conv(x, w, b, neg_slope)
    z = halo(x, mesh, 2)
    return conv(z, w, b, neg_slope)[:, :, 1:-1].contiguous()


def conv3d64_spmd(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], mesh,
                  neg_slope: Optional[float] = None) -> torch.Tensor:
    """K1 over ``mesh``: ``x`` is this rank's block (B/D, T, h, W, 64) of a
    (B, T, H, W, 64) tensor sharded B -> data, H -> spatial; ``w`` and
    ``b`` replicated.  The output is sharded like ``x``.  Differentiable
    any number of times, through K1 and the halo."""
    if x.dim() != 5 or x.shape[-1] != 64:
        raise ValueError(f"x must be a (B,T,h,W,64) block, got "
                         f"{tuple(x.shape)}")
    y = _compose(conv3d64, x, w, b, mesh, neg_slope)
    c = pick(x, counts, ahead_counts)
    if x.is_cuda:
        if x.dtype == torch.bfloat16:
            c.bf16_launches += 1
        else:
            c.launches += 1
    else:
        c.plain_calls += 1
    return y


def conv3d64_spmd_plain(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor], mesh,
                        neg_slope: Optional[float] = None) -> torch.Tensor:
    """The same composition around ``conv3d64_plain`` (plain autograd,
    differentiable any number of times)."""
    return _compose(conv3d64_plain, x, w, b, mesh, neg_slope)
