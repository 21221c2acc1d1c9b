"""The (data, spatial) mesh of ranks and its sharding rules (port of
``hpvaegan_tpu/parallel/mesh.py:33-154``).

The JAX package places a batch on a device mesh and lets GSPMD partition
the jitted step; here every rank is one process of ``torch.distributed``
and runs the step on its own block, explicitly:

* **batch**: rank ``(d, s)`` holds batch rows ``[d*B/D, (d+1)*B/D)``;
  B must divide D (``jax.device_put`` raises there too, ``shard_batch``);
* **H**: it holds one contiguous block of H rows.  Blocks have
  ``ceil(H/S)`` or ``floor(H/S)`` rows, the longer ones first, ordered by
  the spatial coordinate, and every block holds at least one row
  (``block_rows``).  GSPMD shards uneven H too (``spatial_constraint``,
  ``:99-126``), with implicit padding; the port's blocks carry no padding.

Ranks are laid out row-major as the JAX package reshapes its devices:
rank ``d * S + s`` is mesh position ``(d, s)``.  One group per spatial
ring (the ranks of one ``d``) carries the all-gathers of the resize; the
world carries the BatchNorm statistics and the gradient sum; the halo of
a conv goes point to point between ring neighbours
(``ops/kernels/conv3d_spmd.py``).

Operators (``spatial_constraint``'s counterpart, around the inter-stage
resize, which mixes all of H): ``gather_h`` (all-gather forward, the
rank's own block backward) and ``slice_h`` (own block forward,
all-gather backward), ``all_sum``, the differentiable all-reduce
(its backward sums too, as in ``SyncBatchNorm``), and ``gather_rows``,
the differentiable all-gather of small per-rank statistics.  ``ring_sum`` is the
same over the spatial ring alone (``GeneratorVAE_nb``'s pooled latents,
which every rank of a ring holds whole).  ``valid_window`` gives a VALID
conv the input rows its block of the output needs: it gathers the whole
H and narrows it, and its backward sums the windows' cotangents over the
ring (a window may reach past the neighbour's block; a point-to-point
exchange of just those rows is a later optimisation).

The JAX package's ``batch_spec`` chooses which axis a device_put shards;
the port always shards B and H, so it has ``shard`` instead.
``replicate``/``shard_gvars``: parameters are replicated, made so by a
broadcast from rank 0 (``multihost.broadcast_pytree`` of the state dict)
and checked by ``check_replicated``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as _dist
from . import multihost

__all__ = ["Mesh", "parse_mesh_shape",
           "default_mesh_shape", "make_mesh", "block_rows", "shard",
           "shard_batch", "attach", "check_replicated", "state_digest",
           "replicate", "shard_gvars"]

def parse_mesh_shape(spec: str) -> Tuple[int, ...]:
    """'2x4' -> (2, 4); '8' -> (8,)."""
    return tuple(int(p) for p in spec.lower().split("x"))


def default_mesh_shape(n_devices: int) -> Tuple[int, ...]:
    """Split devices into (data, spatial): batch gets 2-way DP when even,
    the rest shards the H axis."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return (2, n_devices // 2)
    return (n_devices,)


def block_rows(n: int, parts: int) -> Sequence[Tuple[int, int]]:
    """The ``(start, stop)`` rows of each of ``parts`` blocks of ``n``
    rows: ``ceil(n/parts)`` rows for the first ``n % parts`` blocks,
    ``floor(n/parts)`` for the rest; raises when a block would be
    empty."""
    if n < parts:
        raise ValueError(f"{n} rows cannot be split over {parts} ranks with "
                         f"at least one row each")
    base, extra = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


class _Gather(torch.autograd.Function):
    """All of H from the spatial ring's blocks; backward keeps this
    rank's block of the cotangent.  That is the adjoint only when every
    rank's cotangent of the whole is the same, i.e. when the whole is
    consumed redundantly and left through ``_Slice``, as around the
    resize."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.gather_blocks(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, ctx.mesh, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    """This rank's block of H; backward gathers the cotangent's blocks."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        start, stop = mesh.block(x.shape[dim])
        return x.narrow(dim, start, stop - start).clone()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.mesh, ctx.dim), None, None


class _GatherSummed(torch.autograd.Function):
    """All of H from the spatial ring's blocks; backward sums the ring's
    cotangents of the whole and keeps this rank's block: the adjoint
    whatever each rank does with its copy."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.gather_blocks(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _SumSlice.apply(g.contiguous(), ctx.mesh, ctx.dim), None, None


class _SumSlice(torch.autograd.Function):
    """This rank's block of the ring's sum of a whole tensor; backward
    gathers the cotangent's blocks (the adjoint of ``_GatherSummed``)."""

    @staticmethod
    def forward(ctx, g, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        total = _dist.all_reduce_(g.clone(), mesh.spatial_group)
        start, stop = mesh.block(g.shape[dim])
        return total.narrow(dim, start, stop - start).clone()

    @staticmethod
    def backward(ctx, gg):
        return (_GatherSummed.apply(gg.contiguous(), ctx.mesh, ctx.dim),
                None, None)


class _GatherRows(torch.autograd.Function):
    """Every rank's ``x`` stacked along a new first dim, in rank order;
    backward sums the cotangents over the ranks and keeps this rank's
    row (through ``_AllSum``, so it is differentiable again)."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return torch.stack(_dist.all_gather(x))

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g.contiguous())[ctx.rank], None


class _AllSum(torch.autograd.Function):
    """Sum over the ranks of ``group`` (the world by default); the
    backward sums the cotangents, since each rank's loss share reached
    the same sum."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        return _dist.all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g.contiguous(), ctx.group), None


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a ``(data, spatial)`` mesh of ranks.

    ``spatial_group`` is the process group of this rank's spatial ring
    (None when S is 1) and ``spatial_ranks`` its global ranks by spatial
    coordinate.  Modules hold the mesh as a plain attribute (``attach``);
    copying a module shares it."""

    shape: Tuple[int, int]
    rank: int
    data_index: int
    spatial_index: int
    spatial_ranks: Tuple[int, ...]
    spatial_group: object = None

    def __deepcopy__(self, memo):
        return self

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_spatial(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's ``(start, stop)`` rows of an H of ``n`` rows."""
        return block_rows(n, self.n_spatial)[self.spatial_index]

    def batch_rows(self, b: int) -> Tuple[int, int]:
        """This rank's ``(start, stop)`` of a global batch of ``b``."""
        if b % self.n_data:
            raise ValueError(f"a batch of {b} does not split over the "
                             f"{self.n_data}-way data axis")
        per = b // self.n_data
        return self.data_index * per, (self.data_index + 1) * per

    def global_batch(self, b_local: int) -> int:
        return b_local * self.n_data

    def neighbours(self) -> Tuple[Optional[int], Optional[int]]:
        """Global ranks of the previous and next block on the spatial
        ring; None at the ring's ends."""
        s, ring = self.spatial_index, self.spatial_ranks
        return (ring[s - 1] if s > 0 else None,
                ring[s + 1] if s + 1 < len(ring) else None)

    # -- layout ----------------------------------------------------------
    def shard(self, x: torch.Tensor, h_dim: int) -> torch.Tensor:
        """This rank's block of a whole tensor: its batch rows (dim 0) and
        its H rows (``h_dim``); a copy, not differentiable."""
        b0, b1 = self.batch_rows(x.shape[0])
        h0, h1 = self.block(x.shape[h_dim])
        return x[b0:b1].narrow(h_dim, h0, h1 - h0).contiguous()

    def gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole H of the spatial ring from each rank's block along
        ``dim`` (not differentiable: ``gather_h`` is).  Blocks are padded
        to the longest for the all-gather and trimmed after."""
        if self.n_spatial == 1:
            return x
        rows = [stop - start for start, stop in
                block_rows(self.ring_count(x.shape[dim]), self.n_spatial)]
        longest = rows[0]
        pad = longest - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = _dist.all_gather(x, self.spatial_group)
        return torch.cat([p.narrow(dim, 0, r) for p, r in zip(parts, rows)],
                         dim)

    def gather_h(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Differentiable all-gather of H; its backward keeps the block."""
        return x if self.n_spatial == 1 else _Gather.apply(x, self, dim)

    def slice_h(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Differentiable block of a whole H; its backward all-gathers."""
        return x if self.n_spatial == 1 else _Slice.apply(x, self, dim)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over every rank of the mesh."""
        return x if self.size == 1 else _AllSum.apply(x)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable all-gather over every rank of the mesh: the
        ranks' ``x`` stacked along a new first dim."""
        if self.size == 1:
            return x.unsqueeze(0)
        return _GatherRows.apply(x.contiguous(), self.rank)

    def ring_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over this rank's spatial ring."""
        return (x if self.n_spatial == 1
                else _AllSum.apply(x, self.spatial_group))

    def ring_count(self, n: int) -> int:
        """``n`` summed over this rank's spatial ring."""
        if self.n_spatial == 1:
            return n
        t = torch.tensor([n], dtype=torch.int64)
        return int(_dist.all_reduce_(t, self.spatial_group)[0])

    def valid_window(self, x: torch.Tensor, dim: int, k: int
                     ) -> torch.Tensor:
        """The rows of the whole input along ``dim`` that this rank's
        block of a VALID conv's output needs, from the blocks ``x``: the
        output of ``H - k + 1`` rows is blocked as any H is
        (``block_rows``), so the window is ``[o_start, o_stop + k - 1)``
        of the whole.  Differentiable any number of times."""
        if self.n_spatial == 1 or k == 1:
            return x
        whole = _GatherSummed.apply(x, self, dim)
        start, stop = self.block(whole.shape[dim] - k + 1)
        return whole.narrow(dim, start, stop - start + k - 1)

    def count(self, t: torch.Tensor) -> int:
        """The elements of the whole tensor whose block ``t`` is."""
        if self.size == 1:
            return t.numel()
        n = torch.tensor([t.numel()], dtype=torch.int64)
        return int(_dist.all_reduce_(n)[0])

    def gather_whole(self, x: torch.Tensor, h_dim: int) -> torch.Tensor:
        """The whole tensor from every rank's block (batch over data, H
        over spatial), on every rank; not differentiable."""
        whole_h = self.gather_blocks(x, h_dim)
        if self.n_data == 1:
            return whole_h
        parts = _dist.all_gather(whole_h)
        return torch.cat(parts[::self.n_spatial], 0)

    def sum_grads(self, params) -> None:
        """Sum the parameters' gradients over every rank, in one
        all-reduce: the cross-rank sum of a replicated parameter's
        cotangent (``shard_map``'s transpose inserts it as a ``psum``)."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.size == 1 or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        _dist.all_reduce_(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def make_mesh(shape: Sequence[int]) -> Mesh:
    """This rank's mesh of ``shape`` ((D,) or (D, S)) over the process
    group; raises when the world is not D * S ranks.  Every rank must call
    it, in the same order as its other group constructions."""
    shape = tuple(int(n) for n in shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"a mesh is (data,) or (data, spatial), got {shape}")
    n = shape[0] * shape[1]
    world, rank = _dist.process_count(), _dist.process_index()
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} processes, have {world}")
    d, s = divmod(rank, shape[1])
    group, ring = None, tuple(range(d * shape[1], (d + 1) * shape[1]))
    if shape[1] > 1:
        for dd in range(shape[0]):   # every rank builds every ring's group
            ranks = list(range(dd * shape[1], (dd + 1) * shape[1]))
            g = dist.new_group(ranks)
            if dd == d:
                group = g
    return Mesh(shape, rank, d, s, ring, group)


def shard(x: torch.Tensor, mesh: Optional[Mesh], h_dim: int) -> torch.Tensor:
    """``mesh.shard(x, h_dim)``, or ``x`` without a mesh."""
    return x if mesh is None else mesh.shard(x, h_dim)


def shard_batch(x: torch.Tensor, mesh: Mesh, ndim_spatial: int
                ) -> torch.Tensor:
    """A whole NTHWC (NHWC) batch cut to this rank's block."""
    return mesh.shard(x, 2 if ndim_spatial == 3 else 1)


def attach(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Put ``module`` and every submodule that has a ``mesh`` attribute
    under ``mesh`` (None: back to one process).  Returns ``module``."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return module


def check_replicated(module: torch.nn.Module) -> None:
    """Raise unless every rank holds the same parameters and buffers, bit
    for bit (one all-gather of a digest a tensor: the sum of its f32 bit
    patterns)."""
    if _dist.process_count() == 1:
        return
    every = _dist.all_gather(state_digest(module))
    if not all(torch.equal(every[0], d) for d in every[1:]):
        raise RuntimeError("the ranks hold different parameters")


def state_digest(module: torch.nn.Module) -> torch.Tensor:
    """One int64 a parameter or buffer: the sum of its values' f32 bit
    patterns (equal values give equal digests)."""
    tensors = list(module.parameters()) + list(module.buffers())
    return torch.tensor(
        [int(np.frombuffer(t.detach().float().cpu().numpy().tobytes(),
                           np.uint32).sum(dtype=np.int64))
         for t in tensors] or [0], dtype=torch.int64)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate a module over the mesh: rank 0's values everywhere
    (checked), the mesh attached (every rank then holds the same copy, as
    ``jax.device_put(P())`` makes it)."""
    multihost.broadcast_pytree(module.state_dict())
    check_replicated(module)
    return attach(module, mesh)


def shard_gvars(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Generator and critic weights are replicated; the activations are
    what the mesh shards."""
    return replicate(module, mesh)
