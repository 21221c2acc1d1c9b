"""The generators (port of ``hpvaegan_tpu/models/generators.py``):
``GeneratorHPVAEGAN`` (``:119-265``), its Bernoulli-gated variant
``GeneratorVAE_nb`` (``:315-416``) and the baselines ``GeneratorCSG``
(ConSinGAN, ``:418-483``) and ``GeneratorSG`` (SinGAN, ``:486-541``).

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
The parameters stay f32.  The amps are Python floats, or the training
steps' f32 tensor (one 0-dim element a stage: the same bits in the
product, and a CUDA graph captured ahead of the scale's calibration
reads its amps from its inputs).
Under a mesh (``parallel.mesh.attach``) the inputs and draws stay whole,
as a single-process run has them, and ``apply`` cuts this rank's block
of each (``Mesh.shard``); every draw it makes itself (``eps``, the stage
noises) is drawn whole from ``generator`` and then cut, so a sharded run
sees the single-process run's numbers.  Its outputs are this rank's
blocks.  Each inter-stage resize mixes all of H (``generators.py:95-110``):
it gathers the ring's blocks (``Mesh.gather_h``), resizes the whole on
every rank of the ring, and keeps the rank's block of the result
(``Mesh.slice_h``).

The split forwards of ``GeneratorHPVAEGAN`` (``generators.py:201-313``)
serve ``--hoist-prefix`` and ``--fused-forwards``:

* ``apply_prefix(..., upto=i)`` runs the encoder or latent, the decoder
  and stages ``[0, i)`` and returns where the noise stream stands (the
  next stage index); ``apply_suffix`` runs stages ``[i, n)`` from there.
  Both read the same ``noises`` list (indexed by stage) or the same
  ``generator``, so prefix + suffix consume the unsplit forward's noises;
* ``apply_fused`` runs the rec and the rand forwards as one batch
  ``[rec | rand]`` through the decoder and the stages: the rec half takes
  zero noise, and BatchNorm computes its statistics over the combined
  batch, moving each layer's running statistics once with them (the
  JAX package's deviation, ``generators.py:273-276``).

``GeneratorVAE_nb`` has no split forwards (``split_forwards`` is False;
in the JAX package it is a separate class without them, and the steps
gate on them), so it runs unfused and unhoisted under those flags.

``GeneratorVAE_nb`` is ``GeneratorHPVAEGAN`` with the ``EncodeVAE_nb``
encoder: its decoder reads ``z_norm * z_bern``, a global Gaussian latent
``(b, latent, 1, 1, 1)`` times a spatial Bernoulli map ``(b, 1, T, H,
W)``; it injects noise at every stage in rand mode, and its refinement
detach at ``vae_levels`` ignores ``train_all`` (a reference quirk,
PARITY.md).  Its draws are injectable as the others: ``eps`` is the pair
``(eps_norm, eps_bern)`` of the rec forward (``reparameterize`` and
``reparameterize_bern``), ``noise_init_norm``/``noise_init_bern`` the
rand forward's latents (``draw_latents``).

The baselines have no encoder: a shared head and tail around a growing
body of VALID-conv stages (``GeneratorCSG``), or a body of whole VALID
sub-generators with a tanh between them (``GeneratorSG``); both start
with their first stage, grow by copying the last, and take image-channel
``noise_init`` (the fixed ``Z_init`` in rec mode).  In rand mode the
previous stage's output is resized to the stage's size plus the VALID
convs' shrink, and noise (``noises[idx]``, shaped like that resize) is
added with ``amps[idx]``; in rec mode the upscale is zero-padded instead.
They return the sample alone, not a triple (``returns_triple``).
Under a mesh with a spatial axis their zero padding is the whole H's
(``networks.pad_spatial``) and each VALID conv runs on the window of the
whole input its output block needs (``models/blocks.py``), so every
stage's output is blocked as any H is.

``--remat``/``--remat-blocks`` (``models/remat.py``, JAX
``generators.py:47-90``): every refinement stage, the VAE decoder and
every baseline stage runs through ``_run``, which recomputes it in the
backward at the level the generator's ``cfg`` asks for at call time, in
every apply mode (``apply``, ``apply_prefix``/``apply_suffix``,
``apply_fused``); the encoder and the baselines' head and tail are not
wrapped, as in the JAX package.

``--wpack`` (``models/packed.py``; JAX ``generators.py:55-80, 260-263,
305-309, 410-413``): the refinement stages of ``GeneratorHPVAEGAN`` and
``GeneratorVAE_nb`` run over W-pair-packed activations wherever their
input's W is even and at least ``packed.WPACK_MIN_W``
(``_run_stage``), in every apply mode, at the same remat levels.  The
decoder and the baselines' stages never pack, as in the JAX package,
which passes them no ``cfg``.
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
from ..utils.profiling import span
from .blocks import ConvBlock, ConvND
from .networks import (CSGStage, Decoder, EncodeVAE, EncodeVAE_nb, SGStage,
                       Stage, pad_spatial, reparameterize,
                       reparameterize_bern)
from .packed import stage_apply_packed, wpack_ok
from .remat import remat, remat_level

__all__ = ["GeneratorHPVAEGAN", "GeneratorVAE_nb", "GeneratorCSG",
           "GeneratorSG", "to_model_layout", "to_public_layout"]


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


def _amp_values(amps):
    """The noise amps as the stages index them: the training steps' f32
    tensor as it is (a CUDA graph then reads them from its inputs instead
    of baking them in; its 0-dim elements multiply as the f32 of the
    Python floats do), else a list of floats (sampling, serving)."""
    if isinstance(amps, torch.Tensor):
        return amps
    return [float(a) for a in amps]


class _PyramidModule(nn.Module):
    """What every generator shares: the pyramid, the compute dtype, the
    mesh, the inter-stage resize and the placement of inputs and draws."""

    mesh = None
    returns_triple = True
    # apply_prefix / apply_suffix / apply_fused (--hoist-prefix,
    # --fused-forwards): GeneratorHPVAEGAN's alone
    split_forwards = False

    def __init__(self, cfg, pyramid: Pyramid, ndim: int):
        super().__init__()
        self.cfg = cfg
        self.pyramid = pyramid
        self.ndim = ndim
        # the convs' compute dtype (None: f32)
        self.dtype = torch.bfloat16 if getattr(cfg, "bf16", False) else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _shape(self, index: int) -> Tuple[int, ...]:
        return (self.pyramid.shape3d(index) if self.ndim == 3
                else self.pyramid.shape2d(index))

    def _upscale(self, x: torch.Tensor, index: int) -> torch.Tensor:
        return self._resize(x, self._shape(index))

    def _resize(self, x: torch.Tensor, size) -> torch.Tensor:
        h_dim = self.ndim   # H of an NCDHW / NCHW tensor
        if self.mesh is not None:
            x = self.mesh.gather_h(x, h_dim)
        if self.ndim == 3:
            x = interpolate_3d(x, size)
        else:
            x = interpolate_2d(x, size)
        return x if self.mesh is None else self.mesh.slice_h(x, h_dim)

    def _local(self, t, dtype=None, batch_only: bool = False
               ) -> torch.Tensor:
        """A whole NTHWC (NHWC) input in the model layout on this module's
        device, cut to this rank's block under a mesh: its batch rows and
        its H rows, or its batch rows alone (``batch_only``: a global
        latent, which every rank of a spatial ring holds whole)."""
        x = to_model_layout(t, self.device, dtype)
        if self.mesh is None:
            return x
        fmt = (torch.channels_last_3d if x.dim() == 5
               else torch.channels_last)
        if batch_only:
            b0, b1 = self.mesh.batch_rows(x.shape[0])
            return x[b0:b1].contiguous(memory_format=fmt)
        return self.mesh.shard(x, self.ndim).contiguous(memory_format=fmt)

    def _run(self, module, x: torch.Tensor, train: bool,
             update_stats: bool) -> torch.Tensor:
        """A stage (or the decoder) on ``x`` at the config's remat level:
        recomputed in the backward under ``--remat``, each conv block too
        under ``--remat-blocks``."""
        level = remat_level(self.cfg)
        return remat(module, x, train, enabled=level,
                     update_stats=update_stats,
                     remat_blocks=level == "blocks")

    def _draw(self, shape, dtype, generator) -> torch.Tensor:
        """N(0, 1) of the whole ``shape`` (model layout) from
        ``generator``, cut to this rank's block under a mesh."""
        noise = generate_noise(size=shape, dtype=dtype, generator=generator,
                               device=self.device)
        return noise if self.mesh is None else self.mesh.shard(noise,
                                                               self.ndim)


class GeneratorHPVAEGAN(_PyramidModule):
    """The core model (networks_3d.py:325-406 / networks_2d.py:188-269)."""

    split_forwards = True

    def __init__(self, cfg, pyramid: Pyramid, ndim: int):
        super().__init__(cfg, pyramid, ndim)
        self.encode = self._encoder()
        self.decoder = Decoder(cfg.latent_dim, cfg.nfc, cfg.nc_im,
                               cfg.ker_size, cfg.padd_size, cfg.num_layer,
                               ndim, dtype=self.dtype)
        self.body = nn.ModuleList()
        # 2D/3D rand-mode noise-injection asymmetry (networks_2d.py:261 vs
        # networks_3d.py:398)
        self.noise_all_stages = (ndim == 2)

    def _encoder(self) -> nn.Module:
        cfg = self.cfg
        return EncodeVAE(cfg.nc_im, cfg.latent_dim, cfg.nfc, cfg.ker_size,
                         cfg.enc_blocks, self.ndim, dtype=self.dtype)

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
        with full_f32():
            z_vae, stats = self._latent(real_zero, noise_init, train, eps,
                                        generator)
            return self._decode_refine(amps, z_vae, stats, sample_init,
                                       mode, train, noises, generator,
                                       update_stats)

    def _latent(self, real_zero, noise_init, train, eps, generator):
        """(the decoder's latent in the model layout, ``(mu, logvar)`` or
        None): ``noise_init``, else ``real_zero`` encoded and
        reparameterized with ``eps``."""
        if noise_init is not None:
            return self._local(noise_init), None
        assert real_zero is not None
        mu, logvar = self.encode(self._local(real_zero))
        if eps is not None:
            eps = self._local(eps)
        elif self.mesh is not None:
            b = self.mesh.global_batch(mu.shape[0])
            eps = self._draw((b, mu.shape[1], *np.shape(real_zero)[1:-1]),
                             mu.dtype, generator)
        z = reparameterize(mu, logvar, train, eps, generator)
        # one layout whether eps was drawn here or handed in, so that the
        # decoder's convs sum in one order either way
        fmt = torch.channels_last_3d if z.dim() == 5 else torch.channels_last
        return z.contiguous(memory_format=fmt), (mu, logvar)

    def draw_eps(self, real_zero_shape,
                 generator: Optional[torch.Generator] = None):
        """The rec forward's reparameterization draw for a ``real_zero`` of
        NTHWC (NHWC) ``real_zero_shape``, exactly as ``apply`` would draw
        it from ``generator`` (a view in the public layout), so that it can
        be drawn ahead and handed in."""
        shape = (real_zero_shape[0], self.cfg.latent_dim,
                 *real_zero_shape[1:-1])
        eps = torch.randn(shape, dtype=self.dtype or torch.float32,
                          device=self.device, generator=generator)
        return to_public_layout(eps)

    def _decode_refine(self, amps, z_vae, stats, sample_init, mode, train,
                       noises, generator, update_stats, stop=None):
        """The decoder on the latent ``z_vae`` (model layout), then the
        refinement stages up to ``stop`` (all by default); returns
        ``apply``'s triple."""
        amps = _amp_values(amps)
        vae_out = torch.tanh(self._run(self.decoder, z_vae, train,
                                       update_stats))
        if sample_init is not None:
            start_idx, x = sample_init[0], self._local(sample_init[1])
            assert len(self.body) > start_idx, \
                "Starting index must be lower than # of body blocks"
        else:
            start_idx, x = 0, vae_out
        x = self._refinement_layers(start_idx, x, amps, mode, train,
                                    noises, generator, update_stats, stop)
        if stats is not None:
            stats = tuple(to_public_layout(s) for s in stats)
        return to_public_layout(x), to_public_layout(vae_out), stats

    def apply_prefix(self, amps: Sequence[float], real_zero=None,
                     noise_init=None, mode: str = "rec", train: bool = True,
                     noises: Optional[Sequence] = None, eps=None,
                     generator: Optional[torch.Generator] = None,
                     update_stats: bool = False, upto: int = 0):
        """The encoder or latent, the decoder and stages ``[0, upto)``
        (JAX ``generators.py:201-232``).  Returns ``(x, vae_out, stats,
        upto)``: ``upto`` is where the noise stream stands, the stage
        ``apply_suffix`` starts at (with the same ``noises`` or
        ``generator``)."""
        with full_f32():
            z_vae, stats = self._latent(real_zero, noise_init, train, eps,
                                        generator)
            x, vae_out, stats = self._decode_refine(
                amps, z_vae, stats, None, mode, train, noises, generator,
                update_stats, stop=upto)
            return x, vae_out, stats, upto

    def apply_suffix(self, amps: Sequence[float], x, start_idx: int,
                     mode: str = "rand", train: bool = True,
                     noises: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     update_stats: bool = False) -> torch.Tensor:
        """Stages ``[start_idx, n)`` from ``apply_prefix``'s ``x`` (NTHWC)
        and stream position (JAX ``generators.py:234-241``)."""
        with full_f32():
            x = self._refinement_layers(
                start_idx, self._local(x, x.dtype), _amp_values(amps),
                mode, train, noises, generator, update_stats)
            return to_public_layout(x)

    def apply_fused(self, amps: Sequence[float], real_zero, noise_init,
                    train: bool = True, noises: Optional[Sequence] = None,
                    eps=None, generator: Optional[torch.Generator] = None,
                    update_stats: bool = False):
        """The rec forward from ``real_zero`` and the rand forward from
        ``noise_init`` as one batch ``[rec | rand]`` through the decoder
        and the stages (``--fused-forwards``, JAX ``generators.py:
        267-313``): the rand half takes the stage noises, the rec half
        zeros; BatchNorm statistics are the combined batch's.  Returns
        ``(generated, fake, vae_out of the rec half, (mu, logvar))``,
        NTHWC."""
        with full_f32():
            z_rec, stats = self._latent(real_zero, None, train, eps,
                                        generator)
            z_rand = self._local(noise_init).to(z_rec.dtype)
            b = z_rec.shape[0]
            fmt = (torch.channels_last_3d if z_rec.dim() == 5
                   else torch.channels_last)
            z_vae = torch.cat([z_rec, z_rand]).contiguous(memory_format=fmt)
            x, vae_out, stats = self._decode_refine(
                amps, z_vae, stats, None, "fused", train, noises, generator,
                update_stats)
            return x[:b], x[b:], vae_out[:b], stats

    def _detach_before(self, idx: int) -> bool:
        """Is stage ``idx``'s input cut from the gradient (the VAE levels
        frozen under the GAN phase, networks_3d.py:397)?"""
        return self.cfg.vae_levels == idx + 1 and not self.cfg.train_all

    def _stage_has_noise(self, idx: int) -> bool:
        """Does stage ``idx`` inject noise in rand mode?"""
        return self.noise_all_stages or self.cfg.vae_levels <= idx + 1

    def draw_stage_noises(self, batch: int,
                          generator: Optional[torch.Generator] = None):
        """One rand-mode forward's stage noises, NTHWC (``None`` for the
        stages without noise): a list to hand to ``apply(noises=...)``,
        so that two forwards can share one draw."""
        return [torch.randn((batch, *self._shape(idx + 1), self.cfg.nc_im),
                            generator=generator, device=self.device,
                            dtype=self.dtype or torch.float32)
                if self._stage_has_noise(idx) else None
                for idx in range(len(self.body))]

    def _run_stage(self, stage, x: torch.Tensor, train: bool,
                   update_stats: bool) -> torch.Tensor:
        """A refinement stage: over packed W under ``--wpack`` at a
        qualifying shape (``models/packed.py``; JAX ``_apply_bn_module``
        with ``cfg``, ``generators.py:55-80``), recomputed in the backward
        at the config's remat level as ``_run``; else ``_run``."""
        if not wpack_ok(self.cfg, x.shape):
            return self._run(stage, x, train, update_stats)
        level = remat_level(self.cfg)
        return remat(stage_apply_packed, stage, x, train, enabled=level,
                     update_stats=update_stats,
                     remat_blocks=level == "blocks")

    def _refinement_layers(self, start_idx: int, x: torch.Tensor,
                           amps: Sequence[float], mode: str, train: bool,
                           noises: Optional[Sequence],
                           generator: Optional[torch.Generator],
                           update_stats: bool,
                           stop: Optional[int] = None) -> torch.Tensor:
        """Stages ``[start_idx, stop)``.  ``mode`` "fused": ``x`` is the
        batch ``[rec | rand]``, and only its rand half takes noise."""
        for idx in range(start_idx, len(self.body) if stop is None
                         else stop):
            with span(f"gen.stage.{idx}"):
                if self._detach_before(idx):
                    x = x.detach()
                x_up = self._upscale(x, idx + 1)
                if mode in ("rand", "fused") and self._stage_has_noise(idx):
                    ref = x_up if mode == "rand" else x_up[x_up.shape[0] // 2:]
                    if noises is not None:
                        noise = self._local(noises[idx], ref.dtype)
                    elif self.mesh is not None:
                        b = self.mesh.global_batch(ref.shape[0])
                        noise = self._draw((b, ref.shape[1],
                                            *self._shape(idx + 1)),
                                           ref.dtype, generator)
                    else:
                        noise = generate_noise(ref=ref, generator=generator)
                    if mode == "fused":
                        noise = torch.cat([torch.zeros_like(noise), noise])
                    # f32, as the JAX package's f32 amps make it
                    x_in = x_up.float() + noise.float() * amps[idx + 1]
                else:
                    x_in = x_up
                y = self._run_stage(self.body[idx], x_in, train, update_stats)
                x = torch.tanh(y + x_up)
        return x


class GeneratorVAE_nb(GeneratorHPVAEGAN):
    """The Bernoulli-gated variant (networks_3d.py:409-485; JAX
    ``generators.py:315-416``).  Its rec forward returns the stats
    ``(mu, logvar, bern)``."""

    # as in the JAX package, where it is a separate class without them:
    # the steps run it unfused and unhoisted whatever the flags
    split_forwards = False

    def __init__(self, cfg, pyramid: Pyramid, ndim: int):
        super().__init__(cfg, pyramid, ndim)
        self.noise_all_stages = True   # both nb variants inject always

    def apply_prefix(self, *args, **kwargs):
        raise NotImplementedError("GeneratorVAE_nb has no split forwards")

    apply_suffix = apply_fused = apply_prefix

    def _encoder(self) -> nn.Module:
        cfg = self.cfg
        return EncodeVAE_nb(cfg.nc_im, cfg.latent_dim, cfg.nfc,
                            cfg.ker_size, cfg.enc_blocks, self.ndim,
                            dtype=self.dtype)

    def _detach_before(self, idx: int) -> bool:
        # no train_all escape here (networks_3d.py:470-471)
        return self.cfg.vae_levels == idx + 1

    def draw_eps(self, real_zero_shape,
                 generator: Optional[torch.Generator] = None):
        """The rec forward's pair ``(eps_norm, eps_bern)`` for a
        ``real_zero`` of NTHWC ``real_zero_shape``, drawn from
        ``generator`` as ``apply`` would draw them (``reparameterize``,
        then ``reparameterize_bern``), in the public layout."""
        kw = dict(dtype=self.dtype or torch.float32, device=self.device,
                  generator=generator)
        b, spatial = real_zero_shape[0], tuple(real_zero_shape[1:-1])
        eps_norm = torch.randn((b, self.cfg.latent_dim, *(1,) * len(spatial)),
                               **kw)
        eps_bern = torch.rand((b, 1, *spatial), **kw)
        return to_public_layout(eps_norm), to_public_layout(eps_bern)

    def _whole_eps(self, real_zero_shape, bern, train: bool, generator):
        """The rec forward's ``(eps_norm, eps_bern)`` drawn whole under a
        mesh, as one process draws them: in eval mode ``eps_bern`` is the
        Bernoulli sample of the whole gate (gathered first)."""
        if train:
            return self.draw_eps(real_zero_shape, generator)
        eps_norm = torch.randn(
            (real_zero_shape[0], *(1,) * (len(real_zero_shape) - 2),
             self.cfg.latent_dim), dtype=self.dtype or torch.float32,
            device=self.device, generator=generator)
        whole = self.mesh.gather_whole(to_public_layout(bern.detach()),
                                       self.ndim - 1)   # H of NTHWC / NHWC
        return eps_norm, torch.bernoulli(whole.float(), generator=generator)

    def draw_latents(self, noise_init,
                     generator: Optional[torch.Generator] = None):
        """The rand forward's latents for the geometry of ``noise_init``
        (NTHWC, its values unused): ``z_norm ~ N(0, 1)`` of shape
        ``(b, 1, .., 1, latent)`` and ``z_bern ~ Bernoulli(0.5)`` of shape
        ``(b, *spatial, 1)``, in ``noise_init``'s dtype, on this module's
        device (JAX ``generators.py:364-371``; the prior of the eval-mode
        ``reparameterize``/``reparameterize_bern``)."""
        shape = tuple(noise_init.shape)
        dtype = (noise_init.dtype if isinstance(noise_init, torch.Tensor)
                 else torch.float32)
        kw = dict(device=self.device, dtype=dtype)
        z_norm = torch.randn((shape[0], *(1,) * (len(shape) - 2),
                              self.cfg.latent_dim), generator=generator,
                             **kw)
        z_bern = torch.bernoulli(torch.full((*shape[:-1], 1), 0.5, **kw),
                                 generator=generator)
        return z_norm, z_bern

    def apply(self, amps: Sequence[float], real_zero=None, noise_init=None,
              noise_init_norm=None, noise_init_bern=None,
              sample_init: Optional[Tuple[int, torch.Tensor]] = None,
              mode: str = "rec", train: bool = True,
              noises: Optional[Sequence] = None, eps=None,
              generator: Optional[torch.Generator] = None,
              update_stats: bool = False):
        """Returns ``(out, vae_out, (mu, logvar, bern) | None)``, NTHWC.

        The decoder reads ``z_norm * z_bern``: from the encoded
        ``real_zero`` reparameterized with ``eps = (eps_norm, eps_bern)``
        (each drawn from ``generator`` when None), or, in rand mode, the
        explicit ``noise_init_norm``/``noise_init_bern``, else
        ``draw_latents(noise_init)``.  Stage noises as
        ``GeneratorHPVAEGAN.apply``'s, at every stage.

        Under a mesh every draw is made whole and cut: ``z_norm`` and
        ``eps_norm`` over the batch alone (every rank of a spatial ring
        holds the same rows), ``z_bern`` and ``eps_bern`` as any spatial
        map."""
        with full_f32():
            if noise_init_norm is None and noise_init is not None:
                noise_init_norm, noise_init_bern = self.draw_latents(
                    noise_init, generator)
            if noise_init_norm is None:
                assert real_zero is not None
                mu, logvar, bern = self.encode(self._local(real_zero))
                if eps is None and self.mesh is not None:
                    eps = self._whole_eps(np.shape(real_zero), bern, train,
                                          generator)
                eps_norm, eps_bern = (None, None) if eps is None else eps
                z_norm = reparameterize(
                    mu, logvar, train,
                    None if eps_norm is None
                    else self._local(eps_norm, batch_only=True), generator)
                z_bern = reparameterize_bern(
                    bern, train,
                    None if eps_bern is None else self._local(eps_bern),
                    generator)
                stats = (mu, logvar, bern)
            else:
                z_norm = self._local(noise_init_norm, batch_only=True)
                z_bern = self._local(noise_init_bern)
                stats = None
            fmt = (torch.channels_last_3d if z_bern.dim() == 5
                   else torch.channels_last)
            z_vae = (z_norm * z_bern).contiguous(memory_format=fmt)
            return self._decode_refine(amps, z_vae, stats, sample_init,
                                       mode, train, noises, generator,
                                       update_stats)


class _Baseline(_PyramidModule):
    """What the two baselines share: a body that starts with its first
    stage and grows by copies of the last (``generators.py:467-472``),
    image-channel noise, and rand/rec forwards whose stage ``idx >= 1``
    reads the previous output resized to level ``idx`` plus the stage's
    shrink (rand: with noise) or zero-padded (rec)."""

    returns_triple = False
    has_head_tail = False
    # every spatial axis shrinks by 2 * shrink in a stage (set by subclass)
    shrink = 0

    def init(self, generator: Optional[torch.Generator] = None):
        """Fresh weights from ``generator`` and a body of one stage."""
        for m in self.children():
            if not isinstance(m, nn.ModuleList):
                m.reset_parameters(generator)
        del self.body[1:]
        self.body[0].reset_parameters(generator)
        return self

    def init_next_stage(self, generator: Optional[torch.Generator] = None):
        """Append a copy of the last stage; ``generator`` is unused (the
        baselines grow without a draw)."""
        self.body.append(copy.deepcopy(self.body[-1]))
        return self

    def _noise_shape(self, idx: int, batch: int) -> Tuple[int, ...]:
        """NTHWC shape of stage ``idx``'s rand-mode noise."""
        size = tuple(d + 2 * self.shrink for d in self._shape(idx))
        return (batch, *size, self._stage_channels)

    def draw_stage_noises(self, batch: int,
                          generator: Optional[torch.Generator] = None):
        """One rand-mode forward's stage noises, NTHWC (``None`` for stage
        0, which takes ``noise_init`` alone)."""
        return [None] + [
            torch.randn(self._noise_shape(idx, batch), generator=generator,
                        device=self.device,
                        dtype=self._noise_dtype or torch.float32)
            for idx in range(1, len(self.body))]

    def _stage_input(self, x, idx, amps, mode, noises, generator):
        """(stage ``idx``'s input, the upscale ``x_up``) from the previous
        output ``x``."""
        x_up = self._upscale(x, idx)
        if mode == "rand":
            size = tuple(d + 2 * self.shrink for d in self._shape(idx))
            x_pad = self._resize(x, size)
            if noises is not None:
                noise = self._local(noises[idx], x_pad.dtype)
            elif self.mesh is not None:
                b = self.mesh.global_batch(x_pad.shape[0])
                noise = self._draw((b, x_pad.shape[1], *size), x_pad.dtype,
                                   generator)
            else:
                noise = generate_noise(ref=x_pad, generator=generator)
            # f32, as the JAX package's f32 amps make it
            return x_pad.float() + noise.float() * amps[idx], x_up
        return pad_spatial(x_up, self.shrink, self.mesh), x_up


class GeneratorCSG(_Baseline):
    """ConSinGAN-style baseline (networks_3d.py:213-269): a shared head
    (``nc_im -> nfc``, one conv block) and tail (``nfc -> nc_im``), each on
    its input zero-padded by 1, around the body of ``CSGStage``s; the
    stage noises have ``nfc`` channels.  Returns ``tanh`` of the tail."""

    has_head_tail = True

    def __init__(self, cfg, pyramid: Pyramid, ndim: int = 3):
        super().__init__(cfg, pyramid, ndim)
        self.shrink = cfg.num_layer
        self._stage_channels = cfg.nfc
        # stage outputs are BatchNorm's, f32 under --bf16 too
        self._noise_dtype = None
        self.head = ConvBlock(cfg.nc_im, cfg.nfc, cfg.ker_size, 1, ndim,
                              dtype=self.dtype, init_mode="n002")
        self.body = nn.ModuleList([CSGStage(cfg.nfc, cfg.ker_size,
                                            cfg.num_layer, ndim,
                                            dtype=self.dtype)])
        self.tail = ConvND(cfg.nfc, cfg.nc_im, cfg.ker_size, 1, ndim,
                           dtype=self.dtype, init_mode="n002")

    def apply(self, amps: Sequence[float], noise_init=None,
              mode: str = "rand", train: bool = True,
              noises: Optional[Sequence] = None,
              generator: Optional[torch.Generator] = None,
              update_stats: bool = False) -> torch.Tensor:
        """The sample (NTHWC) from ``noise_init`` (rand: a fresh draw;
        rec: the fixed ``Z_init``), in the compute dtype."""
        amps = _amp_values(amps)
        with full_f32():
            x = self.head(self._local(noise_init), train, update_stats)
            x = self._run(self.body[0], pad_spatial(x, self.shrink,
                                                    self.mesh), train,
                          update_stats)
            for idx in range(1, len(self.body)):
                x_in, x_up = self._stage_input(x, idx, amps, mode, noises,
                                               generator)
                x = self._run(self.body[idx], x_in, train,
                              update_stats) + x_up
            return to_public_layout(torch.tanh(self.tail(x)))


class GeneratorSG(_Baseline):
    """SinGAN-style baseline (networks_3d.py:272-322): every stage a whole
    VALID sub-generator (``SGStage``) on its input zero-padded by
    ``num_layer + 2``, a tanh between stages and at the end; the stage
    noises have ``nc_im`` channels."""

    def __init__(self, cfg, pyramid: Pyramid, ndim: int = 3):
        super().__init__(cfg, pyramid, ndim)
        self.shrink = cfg.num_layer + 2
        self._stage_channels = cfg.nc_im
        # the resized input is the tanh of a stage's tail: compute dtype
        self._noise_dtype = self.dtype
        self.body = nn.ModuleList([SGStage(cfg.nfc, cfg.nc_im, cfg.ker_size,
                                           cfg.num_layer, ndim,
                                           dtype=self.dtype)])

    def apply(self, amps: Sequence[float], noise_init=None,
              mode: str = "rand", train: bool = True,
              noises: Optional[Sequence] = None,
              generator: Optional[torch.Generator] = None,
              update_stats: bool = False) -> torch.Tensor:
        """As ``GeneratorCSG.apply``."""
        amps = _amp_values(amps)
        with full_f32():
            x = self._run(self.body[0],
                          pad_spatial(self._local(noise_init), self.shrink,
                                      self.mesh), train, update_stats)
            for idx in range(1, len(self.body)):
                x_in, x_up = self._stage_input(torch.tanh(x), idx, amps,
                                               mode, noises, generator)
                x = self._run(self.body[idx], x_in, train,
                              update_stats) + x_up
            return to_public_layout(torch.tanh(x))
