"""The benchmark's yardstick, frozen: the card's published peaks, the
bound of a K1 or K2 launch from its shape, and the operations of a whole
GAN step or sampling request counted from the plain reference.

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
           "k1_bound", "dw_bound", "pair_bound", "step_flops",
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


def _rate(bf16: bool):
    return (2 if bf16 else 4), (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


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


def _meta_models(cfg: dict, ndim: int, shapes, stages: int):
    import torch
    from reference.model import Critic, Generator
    with torch.device("meta"):
        return (Generator(cfg, ndim, shapes, stages), Critic(cfg, ndim))


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


def step_flops(cfg: dict, ndim: int, shapes, stages: int, batch: int
               ) -> int:
    """The FLOPs of one GAN step of the reference (its forwards, both
    backward passes and the penalty's double backward) at these shapes,
    counted by ``torch.utils.flop_counter``'s formulas on the meta device."""
    import torch
    from reference.train import gan_step
    G, D = _meta_models(cfg, ndim, shapes, stages)
    meta = torch.device("meta")
    real = torch.empty((batch, cfg["nc_im"], *shapes[stages]), device=meta)
    real_zero = torch.empty((batch, cfg["nc_im"], *shapes[0]), device=meta)
    d = {"noise_init": torch.empty((batch, cfg["latent_dim"], *shapes[0]),
                                   device=meta),
         "noises": [torch.empty((batch, cfg["nc_im"], *shapes[i + 1]),
                                device=meta) if G.has_noise(i) else None
                    for i in range(stages)],
         "alpha": torch.empty((), device=meta),
         "eps": torch.empty((batch, cfg["latent_dim"], *shapes[0]),
                            device=meta)}
    amps = torch.empty(stages + 1, device=meta)
    with _FlopCount() as counter:
        gan_step(G, D, cfg, real, real_zero, d, amps)
    return counter.total


def request_flops(cfg: dict, ndim: int, shapes, stages: int, batch: int
                  ) -> int:
    """The FLOPs of one rand-mode forward of the reference generator."""
    import torch
    G, _ = _meta_models(cfg, ndim, shapes, stages)
    meta = torch.device("meta")
    z = torch.empty((batch, cfg["latent_dim"], *shapes[0]), device=meta)
    noises = [torch.empty((batch, cfg["nc_im"], *shapes[i + 1]),
                          device=meta) if G.has_noise(i) else None
              for i in range(stages)]
    with _FlopCount() as counter, torch.no_grad():
        G.rand(torch.empty(stages + 1, device=meta), z, noises)
    return counter.total
