"""``GeneratorHPVAEGAN`` (port of ``hpvaegan_tpu/models/generators.py:119-265``).

The JAX generator is a functional object over an explicit ``gvars`` tree;
here it is an ``nn.Module`` that owns ``encode``, ``decoder`` and a growing
``body`` of ``Stage``s.  Stage growth copies the last stage
(``init_next_stage``, networks_3d.py:352-365).

Public layout is the JAX package's: ``apply`` takes and returns NTHWC
(NHWC in 2D) tensors.  Inside, activations are NCDHW views in
``channels_last_3d`` memory format.

Every draw can be handed in: ``noise_init`` (the decoder's latent),
``eps`` (the reparameterization draw of rec mode) and ``noises`` (the
per-stage rand-mode noise).  Whatever is not handed in is drawn from
``generator``.  Tests feed the draws the JAX package made, since torch
cannot reproduce JAX's threefry bits.

Training forwards ask for ``update_stats``: their BatchNorm layers then
move the running statistics towards the batch's, in forward order, as the
JAX package threads ``batch_stats`` (``generators.py:185-198``).

Under ``cfg.bf16`` every conv computes in bf16 (``generators.py:128``)
and the residual stream is bf16 as in the JAX package: ``mu``/``logvar``,
``vae_out``, each upscaled ``x_up``, the stage noise and each stage's
``tanh(y + x_up)``.  The noisy stage input ``x_up + noise * amp`` is f32
there, because the JAX package's amps are an f32 array, so it is
computed in f32 here too (torch would keep ``bf16 * float`` in bf16).
The parameters stay f32.
Under a mesh (``parallel.mesh.attach``) the inputs and draws stay whole,
as a single-process run has them, and ``apply`` cuts this rank's block
of each (``Mesh.shard``); every draw it makes itself (``eps``, the stage
noises) is drawn whole from ``generator`` and then cut, so a sharded run
sees the single-process run's numbers.  Its outputs are this rank's
blocks.  Each inter-stage resize mixes all of H (``generators.py:95-110``):
it gathers the ring's blocks (``Mesh.gather_h``), resizes the whole on
every rank of the ring, and keeps the rank's block of the result
(``Mesh.slice_h``).
``apply_prefix``, ``apply_suffix`` and ``apply_fused`` serve
``--hoist-prefix`` and ``--fused-forwards`` and wait for ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import full_f32
from ..core.pyramid import Pyramid
from ..ops.noise import generate_noise
from ..ops.resize import interpolate_2d, interpolate_3d
from ..parallel.mesh import attach
from .networks import Decoder, EncodeVAE, Stage, reparameterize

__all__ = ["GeneratorHPVAEGAN", "to_model_layout", "to_public_layout"]


def to_model_layout(t, device=None, dtype=None) -> torch.Tensor:
    """NTHWC (NHWC) array or tensor -> NCDHW (NCHW) tensor in
    channels-last memory format (a view when ``t`` is a contiguous tensor
    on ``device``), in ``dtype``: by default float32, or bfloat16 for a
    bfloat16 tensor."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.array(t, dtype=np.float32))  # writable copy
    if dtype is None:
        dtype = torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32
    t = t.to(device=device, dtype=dtype)
    if t.dim() == 5:
        return t.permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
    if t.dim() == 4:
        return t.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    raise ValueError(f"expected a 4D/5D tensor, got {t.dim()}D")


def to_public_layout(t: torch.Tensor) -> torch.Tensor:
    """NCDHW (NCHW) -> NTHWC (NHWC) view."""
    return t.permute(0, 2, 3, 4, 1) if t.dim() == 5 else t.permute(0, 2, 3, 1)


class GeneratorHPVAEGAN(nn.Module):
    """The core model (networks_3d.py:325-406 / networks_2d.py:188-269)."""

    mesh = None

    def __init__(self, cfg, pyramid: Pyramid, ndim: int):
        super().__init__()
        self.cfg = cfg
        self.pyramid = pyramid
        self.ndim = ndim
        # the convs' compute dtype (None: f32)
        self.dtype = torch.bfloat16 if getattr(cfg, "bf16", False) else None
        self.encode = EncodeVAE(cfg.nc_im, cfg.latent_dim, cfg.nfc,
                                cfg.ker_size, cfg.enc_blocks, ndim,
                                dtype=self.dtype)
        self.decoder = Decoder(cfg.latent_dim, cfg.nfc, cfg.nc_im,
                               cfg.ker_size, cfg.padd_size, cfg.num_layer,
                               ndim, dtype=self.dtype)
        self.body = nn.ModuleList()
        # 2D/3D rand-mode noise-injection asymmetry (networks_2d.py:261 vs
        # networks_3d.py:398)
        self.noise_all_stages = (ndim == 2)

    @property
    def device(self) -> torch.device:
        return self.decoder.tail.weight.device

    # -- lifecycle ---------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "GeneratorHPVAEGAN":
        """Fresh encoder/decoder weights from ``generator`` (a generator on
        this module's device) and an empty body."""
        self.encode.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        self.body = nn.ModuleList()
        return self

    def init_next_stage(self, generator: Optional[torch.Generator] = None
                        ) -> "GeneratorHPVAEGAN":
        """Append a refinement stage: a fresh one first, then copies of the
        last (generators.py:153-164)."""
        if len(self.body) == 0:
            cfg = self.cfg
            stage = Stage(cfg.nfc, cfg.nc_im, cfg.ker_size, cfg.padd_size,
                          cfg.num_layer, self.ndim,
                          pconv=getattr(cfg, "pconv_all", False),
                          dtype=self.dtype)
            stage.to(self.device)
            stage.reset_parameters(generator)
            attach(stage, self.mesh)
        else:
            stage = copy.deepcopy(self.body[-1])
        self.body.append(stage)
        return self

    # -- forward -----------------------------------------------------------
    def _upscale(self, x: torch.Tensor, index: int) -> torch.Tensor:
        h_dim = self.ndim   # H of an NCDHW / NCHW tensor
        if self.mesh is not None:
            x = self.mesh.gather_h(x, h_dim)
        if self.ndim == 3:
            x = interpolate_3d(x, self.pyramid.shape3d(index))
        else:
            x = interpolate_2d(x, self.pyramid.shape2d(index))
        return x if self.mesh is None else self.mesh.slice_h(x, h_dim)

    def _local(self, t, dtype=None) -> torch.Tensor:
        """A whole NTHWC (NHWC) input in the model layout on this module's
        device, cut to this rank's block under a mesh."""
        x = to_model_layout(t, self.device, dtype)
        if self.mesh is None:
            return x
        fmt = (torch.channels_last_3d if x.dim() == 5
               else torch.channels_last)
        return self.mesh.shard(x, self.ndim).contiguous(memory_format=fmt)

    def _draw(self, shape, dtype, generator) -> torch.Tensor:
        """N(0, 1) of the whole ``shape`` (model layout) from
        ``generator``, cut to this rank's block under a mesh."""
        noise = generate_noise(size=shape, dtype=dtype, generator=generator,
                               device=self.device)
        return noise if self.mesh is None else self.mesh.shard(noise,
                                                               self.ndim)

    def apply(self, amps: Sequence[float], real_zero=None, noise_init=None,
              sample_init: Optional[Tuple[int, torch.Tensor]] = None,
              mode: str = "rec", train: bool = True,
              noises: Optional[Sequence] = None, eps=None,
              generator: Optional[torch.Generator] = None,
              update_stats: bool = False):
        """Returns ``(out, vae_out, (mu, logvar) | None)``, all NTHWC, in
        the compute dtype.

        ``noise_init`` replaces the encoder (rand mode); otherwise
        ``real_zero`` is encoded and reparameterized with ``eps``.
        ``noises[idx]`` is stage ``idx``'s rand-mode noise, shaped like its
        upscaled input; entries for stages without noise are ignored.
        Under a mesh the inputs are whole and the outputs this rank's
        blocks."""
        amps = [float(a) for a in amps]
        with full_f32():
            if noise_init is None:
                assert real_zero is not None
                mu, logvar = self.encode(self._local(real_zero))
                if eps is not None:
                    eps = self._local(eps)
                elif self.mesh is not None:
                    b = self.mesh.global_batch(mu.shape[0])
                    eps = self._draw(
                        (b, mu.shape[1], *np.shape(real_zero)[1:-1]),
                        mu.dtype, generator)
                z_vae = reparameterize(mu, logvar, train, eps, generator)
                stats = (mu, logvar)
            else:
                z_vae = self._local(noise_init)
                stats = None

            vae_out = torch.tanh(self.decoder(z_vae, train, update_stats))

            if sample_init is not None:
                start_idx, x = sample_init[0], self._local(sample_init[1])
                assert len(self.body) > start_idx, \
                    "Starting index must be lower than # of body blocks"
            else:
                start_idx, x = 0, vae_out

            x = self._refinement_layers(start_idx, x, amps, mode, train,
                                        noises, generator, update_stats)
        if stats is not None:
            stats = tuple(to_public_layout(s) for s in stats)
        return to_public_layout(x), to_public_layout(vae_out), stats

    def _stage_has_noise(self, idx: int) -> bool:
        """Does stage ``idx`` inject noise in rand mode?"""
        return self.noise_all_stages or self.cfg.vae_levels <= idx + 1

    def draw_stage_noises(self, batch: int,
                          generator: Optional[torch.Generator] = None):
        """One rand-mode forward's stage noises, NTHWC (``None`` for the
        stages without noise): a list to hand to ``apply(noises=...)``,
        so that two forwards can share one draw."""
        shape = (self.pyramid.shape3d if self.ndim == 3
                 else self.pyramid.shape2d)
        return [torch.randn((batch, *shape(idx + 1), self.cfg.nc_im),
                            generator=generator, device=self.device,
                            dtype=self.dtype or torch.float32)
                if self._stage_has_noise(idx) else None
                for idx in range(len(self.body))]

    def _refinement_layers(self, start_idx: int, x: torch.Tensor,
                           amps: Sequence[float], mode: str, train: bool,
                           noises: Optional[Sequence],
                           generator: Optional[torch.Generator],
                           update_stats: bool) -> torch.Tensor:
        for idx in range(start_idx, len(self.body)):
            if self.cfg.vae_levels == idx + 1 and not self.cfg.train_all:
                x = x.detach()
            x_up = self._upscale(x, idx + 1)
            if mode == "rand" and self._stage_has_noise(idx):
                if noises is not None:
                    noise = self._local(noises[idx], x_up.dtype)
                elif self.mesh is not None:
                    b = self.mesh.global_batch(x_up.shape[0])
                    shape = (self.pyramid.shape3d if self.ndim == 3
                             else self.pyramid.shape2d)(idx + 1)
                    noise = self._draw((b, x_up.shape[1], *shape),
                                       x_up.dtype, generator)
                else:
                    noise = generate_noise(ref=x_up, generator=generator)
                # f32, as the JAX package's f32 amps make it
                x_in = x_up.float() + noise.float() * amps[idx + 1]
            else:
                x_in = x_up
            y = self.body[idx](x_in, train, update_stats)
            x = torch.tanh(y + x_up)
        return x
