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
import threading

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "full_f32", "deterministic"]


class _HeldFlags:
    """Process-wide flags held while any thread is inside the block: the
    first holder saves the previous values and sets the block's, the last
    one out restores them.  A plain save-and-restore would let a thread
    leaving the block restore the old values while another thread's step
    is still inside it (``--compile-ahead`` runs the next scale's step on
    a thread of its own)."""

    def __init__(self, get, put, value):
        self._get, self._put, self._value = get, put, value
        self._lock = threading.Lock()
        self._holders = 0
        self._saved = None

    @contextlib.contextmanager
    def hold(self):
        with self._lock:
            if self._holders == 0:
                self._saved = self._get()
                self._put(self._value)
            self._holders += 1
        try:
            yield
        finally:
            with self._lock:
                self._holders -= 1
                if self._holders == 0:
                    self._put(self._saved)


def _get_tf32():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _put_tf32(flags) -> None:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _put_deterministic(flag) -> None:
    torch.backends.cudnn.deterministic = flag


_F32 = _HeldFlags(_get_tf32, _put_tf32, (False, False))
_DETERMINISTIC = _HeldFlags(lambda: torch.backends.cudnn.deterministic,
                            _put_deterministic, True)


def full_f32():
    """Run stock f32 convs and matmuls in full f32 inside the block.

    cuDNN runs f32 convs in TF32 by default (about three decimal digits),
    so the stock convs of the model (encoder, 3 -> 64 heads, 64 -> 3 tails,
    decoder) would drift from the JAX package's f32 result while the K1
    kernel computes in f32.  The port holds f32 semantics end to end; the
    previous settings come back when the last thread inside leaves.
    Under ``--bf16`` the convs take bf16 operands instead (flax's
    ``nn.Conv(dtype=bf16)``), which these flags do not touch; the f32
    parts of a bf16 model (BatchNorm, the resize, spectral norm) still
    run in full f32."""
    return _F32.hold()


def deterministic():
    """Run stock convs on cuDNN's deterministic algorithms inside the
    block.

    cuDNN's default choice for an f32 conv's weight gradient sums in an
    order that changes from run to run, so two f32 training runs of the
    same seeds drifted apart from their first step on the card (the first
    gradients to differ are those of the stock 3 -> 64 head convs; the
    port's own kernels reduce in a fixed order).  The JAX package's
    training is reproducible, and so is the port's inside this block, in
    f32 and bf16; the training steps hold it around every step.  The
    previous setting comes back when the last thread inside leaves."""
    return _DETERMINISTIC.hold()


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
