"""Noise generation on explicit ``torch.Generator``s.

Port of ``hpvaegan_tpu/ops/noise.py:19-39``.  The JAX package threads
``jax.random`` keys; here every draw takes a ``torch.Generator`` (or the
global generator when none is given).  The two give different numbers from
the same seed, so the models also accept their draws as explicit tensors.
The reference's quirks stay: the (sic) ``'benoulli'`` type name is
accepted, and unknown types fall through to uniform.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["generate_noise"]


def generate_noise(ref: Optional[torch.Tensor] = None,
                   size: Optional[Sequence[int]] = None, type: str = "normal",
                   emb_size: Optional[int] = None, dtype=torch.float32,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """N(0,1) noise shaped like ``ref`` (its dtype, device and memory
    format) or ``size`` (utils/images.py:39-57)."""
    if ref is not None:
        shape, dtype, device = ref.shape, ref.dtype, ref.device
    elif size is not None:
        shape = tuple(size)
    else:
        raise ValueError("ref or size must be applied")
    kw = dict(generator=generator, device=device)

    if type == "normal":
        out = torch.randn(shape, dtype=dtype, **kw)
    elif type in ("benoulli", "bernoulli"):  # reference typo kept as alias
        out = torch.bernoulli(torch.full(shape, 0.5, dtype=dtype,
                                         device=device), generator=generator)
    elif type == "int":
        assert emb_size is not None and size is not None
        return torch.randint(0, emb_size, shape, **kw)
    else:
        out = torch.rand(shape, dtype=dtype, **kw)  # default == uniform
    if ref is not None and ref.dim() == 5 and ref.is_contiguous(
            memory_format=torch.channels_last_3d):
        out = out.contiguous(memory_format=torch.channels_last_3d)
    return out
