"""The shapes of the K1 and K2 launches, recorded around the kernel
layer's entry points (``ops/kernels/conv3d_pack._forward`` and
``conv3d64_dw``, ``ops/kernels/conv3d_fuse.conv3d64_pair_forward``) in a
traced run, so that a roofline reader can price each launch's work.

A launch made while its stream captures a CUDA graph is marked
``captured``: every replay of that graph runs it again, with no Python
call to see.  Each record is ``(kernel, kind, (B, T, H, W), bias, bf16,
captured, phase)``: kernel ``"k1"`` (kind ``fwd``, ``dx`` or ``dw``) or
``"k2"`` (kind ``mid`` when the intermediate is written for the
backward, else ``fwd``); ``phase`` is the runner's label at the call."""
from __future__ import annotations

import functools
from typing import List

import torch

__all__ = ["LaunchLog"]


class LaunchLog:
    def __init__(self):
        self.records: List[tuple] = []
        self.phase = "setup"
        self._undo = []

    def _add(self, kernel: str, kind: str, x: torch.Tensor, bias: bool):
        if x.is_cuda:
            self.records.append((kernel, kind, tuple(x.shape[:4]), bias,
                                 x.dtype == torch.bfloat16,
                                 torch.cuda.is_current_stream_capturing(),
                                 self.phase))

    def install(self) -> "LaunchLog":
        from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse, conv3d_pack

        def patch(module, name, record):
            original = getattr(module, name)

            @functools.wraps(original)
            def wrapped(*args, **kwargs):
                record(*args, **kwargs)
                return original(*args, **kwargs)
            setattr(module, name, wrapped)
            self._undo.append((module, name, original))

        patch(conv3d_pack, "_forward",
              lambda x, w, b, neg_slope, kind: self._add(
                  "k1", kind, x, b is not None))
        patch(conv3d_pack, "conv3d64_dw",
              lambda x, dy: self._add("k1", "dw", x, False))
        patch(conv3d_fuse, "conv3d64_pair_forward",
              lambda x, *a, with_mid=False, **kw: self._add(
                  "k2", "mid" if with_mid else "fwd", x, True))
        return self

    def remove(self) -> None:
        for module, name, original in reversed(self._undo):
            setattr(module, name, original)
        self._undo.clear()

    def launches(self, kernel: str, phase: str, replays: int) -> List[tuple]:
        """The launches ``(kind, shape, bias, bf16)`` of ``kernel`` a
        traced window ran: those made in ``phase`` outside a capture, and
        every captured one ``replays`` times over."""
        out = []
        for k, kind, shape, bias, bf16, captured, ph in self.records:
            if k != kernel:
                continue
            if captured:
                out.extend([(kind, shape, bias, bf16)] * replays)
            elif ph == phase:
                out.append((kind, shape, bias, bf16))
        return out
