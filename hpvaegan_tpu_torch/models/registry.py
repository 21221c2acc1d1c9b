"""String-dispatched model zoo (port of ``hpvaegan_tpu/models/registry.py``).

The port has ``GeneratorHPVAEGAN`` and the SN ``WDiscriminator``; the
other models of the JAX registry are named here and raise until their
ROADMAP item lands.
"""
from __future__ import annotations

import torch

from ..core.pyramid import Pyramid
from .generators import GeneratorHPVAEGAN
from .networks import WDiscriminator

__all__ = ["make_generator", "make_discriminator", "GENERATORS"]

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


def make_discriminator(name: str, cfg, ndim: int) -> WDiscriminator:
    """The critic of ``hpvaegan_tpu/models/registry.py:36-46``: K1 under
    ``--pconv`` or ``--pconv-all``, K2 pairs under ``--pfuse``, bf16
    convs under ``--bf16`` (the generator reads ``cfg.bf16`` itself, as
    ``generators.py:128`` does)."""
    if name in ("WDiscriminator2D", "WDiscriminator3D"):
        expected = 2 if name.endswith("2D") else 3
        if expected != ndim:
            raise ValueError(f"{name} is {expected}D but trainer is {ndim}D")
        return WDiscriminator(cfg.nc_im, cfg.nfc, cfg.ker_size,
                              cfg.num_layer, ndim,
                              pconv=bool(cfg.pconv or cfg.pconv_all),
                              pfuse=bool(cfg.pfuse),
                              dtype=torch.bfloat16 if cfg.bf16 else None)
    if name == "WDiscriminatorBaselines":
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP Queue 1 item 7 (baselines)")
    raise ValueError(f"unknown discriminator: {name!r}")
