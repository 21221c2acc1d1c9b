"""The benchmark's yardstick, frozen: the card's published peaks, the
bound of a K1 or K2 launch from its shape, and the operations of a whole
training step or sampling request counted on the plain reference (the
model family's, found by the configuration's ``generator``).

Peaks: NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s f32 outside the
tensor cores (the measured package runs f32 with TF32 off), 989 TFLOP/s
bf16, 3.35 TB/s HBM, all at the full 700 W limit.

A launch's bound is the larger of its operations at the peak rate and
its bytes at the HBM rate, each input read once and each output written
once (PERF.md section 6):

* K1 (one 3x3x3 64 -> 64 conv, forward or input gradient):
  ``2 * 27 * 64 * 64`` FLOP an output voxel; x read, y written
  (``64`` values a voxel each), the weights and the bias read;
* K1's weight gradient: the same operations; x and dy read, dw written;
* K2 (two such convs fused): twice the operations; x read, y (and the
  intermediate z, when the backward keeps it) written, both weights and
  biases read.
"""
from __future__ import annotations

from typing import Sequence, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
_TAPS = 27 * 64 * 64

__all__ = ["PEAK_F32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "bound",
           "peak_flops", "k1_bound", "dw_bound", "pair_bound", "step_flops",
           "request_flops"]


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS
          ) -> Tuple[float, str]:
    """(seconds, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _voxels(shape: Sequence[int]) -> int:
    b, t, h, w = shape[:4]
    return b * t * h * w


def peak_flops(bf16: bool) -> float:
    """The peak of the compute dtype: bf16's tensor cores, or f32 outside
    them."""
    return PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS


def _rate(bf16: bool):
    return (2 if bf16 else 4), peak_flops(bf16)


def k1_bound(shape, bias: bool = True, bf16: bool = False):
    v, (e, peak) = _voxels(shape), _rate(bf16)
    return bound(2 * _TAPS * v, e * (2 * v * 64 + _TAPS + 64 * bias), peak)


def dw_bound(shape, bf16: bool = False):
    v, (e, peak) = _voxels(shape), _rate(bf16)
    return bound(2 * _TAPS * v, e * 2 * v * 64 + 4 * _TAPS, peak)


def pair_bound(shape, with_mid: bool = False, bf16: bool = False):
    v, (e, peak) = _voxels(shape), _rate(bf16)
    return bound(2 * 2 * _TAPS * v,
                 e * ((2 + with_mid) * v * 64 + 2 * (_TAPS + 64)), peak)


class _FlopCount:
    """A dispatch mode summing ``torch.utils.flop_counter``'s per-operator
    FLOP formulas (its ``flop_registry``: convolutions and their
    backward, matrix products); elementwise work counts nothing.  It
    tracks no modules, so ``autograd.grad`` (the penalty) runs under it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.total = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                rule = flop_registry.get(func._overloadpacket)
                if rule is not None:
                    counter.total += int(rule(*args, **kwargs, out_val=out))
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _count(cfg: dict, ndim: int, shapes, stages: int, run) -> int:
    """The FLOPs of ``run(family, G, D, meta)`` on the model family's
    reference models (``cfg``'s ``generator``) built on the meta device."""
    import torch
    from .cells import family
    fam, meta = family(cfg["generator"]), torch.device("meta")
    with meta:
        G, D = fam.models(cfg, ndim, shapes, stages)
    with _FlopCount() as counter:
        run(fam, G, D, meta)
    return counter.total


def step_flops(cfg: dict, ndim: int, shapes, stages: int, batch: int
               ) -> int:
    """The FLOPs of one training step of the reference (the family's
    ``flop_step``: its forwards and backward passes, a penalty's double
    backward included) at these shapes, counted by
    ``torch.utils.flop_counter``'s formulas on the meta device."""
    return _count(cfg, ndim, shapes, stages, lambda fam, G, D, dev:
                  fam.flop_step(G, D, cfg, batch, dev))


def request_flops(cfg: dict, ndim: int, shapes, stages: int, batch: int
                  ) -> int:
    """The FLOPs of one sampling request of the reference generator (the
    family's ``flop_request``)."""
    return _count(cfg, ndim, shapes, stages, lambda fam, G, D, dev:
                  fam.flop_request(G, cfg, batch, dev))
