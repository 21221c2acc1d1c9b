"""Width-packed execution paths of the hot conv stacks (``--wpack``; port
of ``hpvaegan_tpu/models/packed.py``).

``stage_apply_packed`` and ``wdisc_apply_packed`` run the forwards of a
``Stage`` (head ``ConvBlock`` + ``num_layer`` ``ConvBlock``s + linear
tail) and of the SN ``WDiscriminator`` (SN head + SN body + linear tail)
with every conv on W-pair-packed activations (``ops/wpack.py``).  They
read the modules themselves: the same parameters, the same spectral
``sigma()`` from the stored u/v, the same state-dict keys, so packing is
a run-time execution path and a checkpoint does not change.  A stage conv
routed to K1 (``--pconv-all``) holds its kernel in THWIO; the packed path
reads it in torch's layout.  No kernel of ``ops/kernels`` runs inside: at
a qualifying shape packing takes precedence over ``--pconv``,
``--pconv-all`` and ``--pfuse`` (the JAX order, ``generators.py:55-80``,
``train/steps.py:43-70``).

The packed BatchNorm ties each channel's statistics across the two W
halves of the P-rep.  Here it is the stage's own ``_BatchNorm`` applied
to the P-rep's unpacked view (a view in channels-last memory): the same
statistics (the variance about the joint mean), the same formula, the
same running-stat move, under a mesh the same mesh statistics
(``_BatchNorm._mesh_forward``), and under ``--remat`` moved once
(``models/remat.py``).  The JAX module averages the halves' means and
second moments, which is the same joint statistic.

Eligibility (``wpack_ok``): ``cfg.wpack``, ker_size 3 and padd_size 1
(the Q -> P tap derivation assumes a (1, 1) W pad), W even and at least
``WPACK_MIN_W`` (read at call time).  The shapes are channels-first, W
last.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.wpack import can_wpack, conv_packed, qpack, unpack_p
from .blocks import activation
from .remat import remat

__all__ = ["WPACK_MIN_W", "wpack_ok", "stage_apply_packed",
           "wdisc_apply_packed"]

WPACK_MIN_W = 128


def wpack_ok(cfg, shape) -> bool:
    """Does the packed path apply to an activation of ``shape`` (NCDHW or
    NCHW) under ``cfg``?"""
    return bool(getattr(cfg, "wpack", False)
                and cfg.ker_size == 3 and cfg.padd_size == 1
                and can_wpack(shape, WPACK_MIN_W))


def _torch_weight(conv) -> torch.Tensor:
    """A ``ConvND``'s kernel in torch's ``(O, I, *k)`` layout (a K1-routed
    conv holds THWIO ``(3, 3, 3, I, O)``)."""
    w = conv.weight
    return w.permute(4, 3, 0, 1, 2) if conv.kernel_route else w


def _packed(conv, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``conv``'s convolution of ``x`` with ``weight`` and ``bias`` over
    packed W, unpacked in and out: ``x`` cast to the conv's compute dtype,
    folded into the Q-rep, convolved to the P-rep, unfolded."""
    dtype: Optional[torch.dtype] = conv.dtype
    xq = qpack(x if dtype is None else x.to(dtype))
    return unpack_p(conv_packed(xq, weight, bias, dtype, conv.mesh))


def _conv_block(block, x: torch.Tensor, train: bool,
                update_stats: bool = False) -> torch.Tensor:
    """A ``ConvBlock`` (conv, BatchNorm in f32, LeakyReLU) over packed W."""
    y = _packed(block.conv, x, _torch_weight(block.conv), block.conv.bias)
    return activation(block.norm(y, train, update_stats), "lrelu")


def _linear(conv, x: torch.Tensor) -> torch.Tensor:
    """A linear ``ConvND`` (the tails) over packed W."""
    return _packed(conv, x, _torch_weight(conv), conv.bias)


def _sn_block(conv, x: torch.Tensor) -> torch.Tensor:
    """An ``SNConv`` (``weight / sigma``, LeakyReLU) over packed W."""
    w, b = conv.normalized()
    return activation(_packed(conv, x, w, b), "lrelu")


def stage_apply_packed(stage, x: torch.Tensor, train: bool = True,
                       update_stats: bool = False,
                       remat_blocks: bool = False) -> torch.Tensor:
    """``stage``'s forward (a ``Stage``: ``_ConvStack.forward``) over packed
    activations; the output is raw, as the stage's.  ``update_stats``
    moves the BatchNorm running statistics as the stage's own forward
    does; ``remat_blocks`` recomputes each block and the tail in the
    backward (``--remat-blocks``)."""
    for block in (stage.head, *stage.blocks):
        x = remat(_conv_block, block, x, train, enabled=remat_blocks,
                  update_stats=update_stats)
    return remat(_linear, stage.tail, x, enabled=remat_blocks)


def wdisc_apply_packed(D, x: torch.Tensor,
                       remat_blocks: bool = False) -> torch.Tensor:
    """The SN ``WDiscriminator``'s forward over packed activations (its
    tail pad hard-coded to 1, as the module's); ``remat_blocks``:
    recompute each block and the tail in the backward."""
    x = remat(_sn_block, D.head, x, enabled=remat_blocks)
    for block in D.body:
        x = remat(_sn_block, block, x, enabled=remat_blocks)
    return remat(_linear, D.tail, x, enabled=remat_blocks)
