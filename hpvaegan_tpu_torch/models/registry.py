"""String-dispatched model zoo (port of ``hpvaegan_tpu/models/registry.py``).

This slice ports ``GeneratorHPVAEGAN``; the other generators of the JAX
registry are named here and raise until their ROADMAP item lands.
"""
from __future__ import annotations

from ..core.pyramid import Pyramid
from .generators import GeneratorHPVAEGAN

__all__ = ["make_generator", "GENERATORS"]

GENERATORS = {"GeneratorHPVAEGAN": GeneratorHPVAEGAN}

# generators of the JAX package not ported yet -> their ROADMAP item
_LATER = {
    "GeneratorVAE_nb": "Queue 1 item 6 (GeneratorVAE_nb + EncodeVAE_nb)",
    "GeneratorCSG": "Queue 1 item 7 (baselines)",
    "GeneratorSG": "Queue 1 item 7 (baselines)",
}


def make_generator(name: str, cfg, pyramid: Pyramid, ndim: int):
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP {_LATER[name]}")
    if name not in GENERATORS:
        raise ValueError(f"unknown generator: {name!r} "
                         f"(have {sorted(GENERATORS) + sorted(_LATER)})")
    return GENERATORS[name](cfg, pyramid, ndim)
