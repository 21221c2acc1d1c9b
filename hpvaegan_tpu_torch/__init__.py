"""hpvaegan_tpu_torch — the PyTorch/CUDA port of hpvaegan_tpu for Hopper.

The JAX package ``hpvaegan_tpu`` stays the reference; this package runs the
same models with PyTorch on an NVIDIA H100, its TPU kernels rewritten as
CUDA kernels for ``sm_90a`` (``csrc/``).  It imports neither JAX nor the
JAX package.

Layouts: inside the models activations are NCDHW tensors in
``torch.channels_last_3d`` memory format, so ``x.permute(0, 2, 3, 4, 1)``
is a free NTHWC view, the layout the kernels take.  Public functions keep
the JAX package's layouts: samples are NTHWC, conv weights THWIO.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without a card they raise instead of falling back.
"""
from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "full_f32"]


@contextlib.contextmanager
def full_f32():
    """Run stock f32 convs and matmuls in full f32 inside the block.

    cuDNN runs f32 convs in TF32 by default (about three decimal digits),
    so the stock convs of the model (encoder, 3 -> 64 heads, 64 -> 3 tails,
    decoder) would drift from the JAX package's f32 result while the K1
    kernel computes in f32.  The port holds f32 semantics end to end; the
    previous settings come back on exit.  Under ``--bf16`` the convs take
    bf16 operands instead (flax's ``nn.Conv(dtype=bf16)``), which these
    flags do not touch; the f32 parts of a bf16 model (BatchNorm, the
    resize, spectral norm) still run in full f32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
