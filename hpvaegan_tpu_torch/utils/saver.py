"""The port's generator checkpoint (counterpart of ``hpvaegan_tpu/utils/saver.py``).

A ``netG`` file is a ``torch.save`` payload with the fields of the JAX
package's ``netG`` (train_video.py:247-252):

  scale       the scale the generator was saved at (= number of stages)
  noise_amps  the per-scale noise amplitudes
  gvars       the generator's ``state_dict`` (weights, BatchNorm running
              statistics, spectral-norm u/v)

``restore_generator`` replays stage growth before loading, as
``hpvaegan_tpu/serving.py:154-160`` does.  Reading the JAX package's
flax-msgpack checkpoints waits for a later slice (ROADMAP).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import torch

__all__ = ["save_generator", "restore_file", "restore_generator"]


def save_generator(path: str, G, scale: int,
                   noise_amps: Sequence[float]) -> None:
    """Write ``G`` atomically (a reader never sees a partial file)."""
    payload = {
        "scale": int(scale),
        "noise_amps": [float(a) for a in noise_amps],
        "gvars": {k: v.detach().cpu() for k, v in G.state_dict().items()},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_file(path: str) -> Dict[str, Any]:
    """The payload of a port checkpoint, tensors on the CPU."""
    if not os.path.isfile(path):
        raise RuntimeError(f"=> no <G> checkpoint found at '{path}'")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_generator(path: str, G,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
    """Grow ``G`` (fresh encoder/decoder, empty body) to the checkpointed
    scale, then load its state.  Returns the payload."""
    raw = restore_file(path)
    for _ in range(int(raw["scale"])):
        G.init_next_stage(generator)
    G.load_state_dict(raw["gvars"])
    return raw
