"""String-dispatched model zoo (port of ``hpvaegan_tpu/models/registry.py``):
the four generators and the two critics of the JAX registry."""
from __future__ import annotations

import torch

from ..core.pyramid import Pyramid
from .generators import (GeneratorCSG, GeneratorHPVAEGAN, GeneratorSG,
                         GeneratorVAE_nb)
from .networks import WDiscriminator, WDiscriminatorBaselines

__all__ = ["make_generator", "make_discriminator", "GENERATORS"]

GENERATORS = {
    "GeneratorHPVAEGAN": GeneratorHPVAEGAN,
    "GeneratorVAE_nb": GeneratorVAE_nb,
    "GeneratorCSG": GeneratorCSG,
    "GeneratorSG": GeneratorSG,
}


def make_generator(name: str, cfg, pyramid: Pyramid, ndim: int):
    if name not in GENERATORS:
        raise ValueError(f"unknown generator: {name!r} "
                         f"(have {sorted(GENERATORS)})")
    return GENERATORS[name](cfg, pyramid, ndim)


def make_discriminator(name: str, cfg, ndim: int):
    """The critic of ``hpvaegan_tpu/models/registry.py:36-52``: the SN
    ``WDiscriminator`` with K1 under ``--pconv`` or ``--pconv-all`` and K2
    pairs under ``--pfuse``, or the baselines' BatchNorm critic, which has
    no kernel route; bf16 convs under ``--bf16`` (the generator reads
    ``cfg.bf16`` itself, as ``generators.py:128`` does)."""
    dtype = torch.bfloat16 if cfg.bf16 else None
    if name in ("WDiscriminator2D", "WDiscriminator3D"):
        expected = 2 if name.endswith("2D") else 3
        if expected != ndim:
            raise ValueError(f"{name} is {expected}D but trainer is {ndim}D")
        return WDiscriminator(cfg.nc_im, cfg.nfc, cfg.ker_size,
                              cfg.num_layer, ndim,
                              pconv=bool(cfg.pconv or cfg.pconv_all),
                              pfuse=bool(cfg.pfuse), dtype=dtype)
    if name == "WDiscriminatorBaselines":
        return WDiscriminatorBaselines(cfg.nc_im, cfg.nfc, cfg.ker_size,
                                       cfg.padd_size, cfg.num_layer, ndim,
                                       dtype=dtype)
    raise ValueError(f"unknown discriminator: {name!r}")
