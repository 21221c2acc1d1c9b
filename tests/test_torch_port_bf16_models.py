"""The port under ``--bf16`` against the JAX package under ``bf16=True``:
a tiny nfc-64 ``GeneratorHPVAEGAN`` (``pconv_all``, so the K1 route's
plain version runs in bf16) in rand and rec mode, the bf16 critic
(``pconv`` + ``pfuse``: one K2 pair and one K1 block through their plain
versions), the dtypes at every point the two frameworks could round
differently, the bf16 resize, and ``SamplerSession`` reading ``bf16``
from a run's ``config.json``.

Same weights (``utils/convert.py``; the parameters stay f32 under bf16)
and the same draws: the JAX draws are made in bf16 where the JAX package
makes them so (``jax.random.normal(k, shape, jnp.bfloat16)``: the stage
noise and the reparameterization draw) and handed over as exact f32
values.

Tolerances, in units of bf16 rounding: the JAX package's bars, 5e-2 of
max(|ref|, 1) for a bf16 conv stack (tests/test_pconv.py:49-57).  The two
sides round at the same points but not always to the same neighbour: the
JAX package's tiny shapes take flax's stock bf16 conv (product rounded,
then the bias added in bf16: two roundings) where the port's K1 route
adds the bias in f32 and rounds once, and the port's SN K1 route applies
its LeakyReLU in f32 before rounding where the JAX package applies it to
the rounded output; each is at most one bf16 ulp (2**-8 relative) a
layer, and a few layers of those stay far inside the bar."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.models.generators as jgenerators
from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.ops import resize as jresize
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.generators import (to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.ops import resize as tresize
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.utils import convert
from hpvaegan_tpu_torch.utils.saver import save_generator

BAR = 5e-2
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True,
            bf16=True)
SCALE, BATCH = 2, 2
AMPS = [1.0, 0.3, 0.2]
BF16 = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.float32): torch.float32}


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


def _assert_close(got: torch.Tensor, ref, bar=BAR):
    """Same dtype, and within ``bar * max(|ref|, 1)``."""
    assert got.dtype == BF16[jnp.dtype(ref.dtype)], (got.dtype, ref.dtype)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(got.detach().float().numpy() - ref)))
    assert err <= bar * scale, (err, bar * scale)


@pytest.fixture(scope="module")
def models():
    """The JAX bf16 generator grown to SCALE, and the port's bf16
    generator converted from it."""
    jcfg = _cfg(JConfig)
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    for i in range(SCALE):
        gvars = jax.jit(jG.init_next_stage)(gvars,
                                            jax.random.fold_in(key, 100 + i))
    gvars = jax.tree_util.tree_map(np.asarray, gvars)
    cfg = _cfg(Config)
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    return jG, gvars, G, cfg


def _bf16_normal(key, shape) -> np.ndarray:
    """A JAX bf16 draw as exact f32 values."""
    return np.asarray(jax.random.normal(key, shape, jnp.bfloat16).astype(
        jnp.float32))


def _replay(key, pyramid, vae_levels, n_stages):
    """The JAX forward's draws (generators.py:174, 255-256): the
    reparameterization key, then one bf16 noise per noisy stage."""
    key, k_rep = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        if vae_levels <= idx + 1:
            key, k_n = jax.random.split(key)
            noises.append(_bf16_normal(
                k_n, (BATCH, *pyramid.shape3d(idx + 1), 3)))
        else:
            noises.append(None)
    return k_rep, noises


def _jax_apply(jG, gvars, key, **kw):
    return jax.jit(lambda gv, k: jG.apply(gv, jnp.asarray(AMPS), k, train=True,
                                          **kw)[0])(gvars, key)


def test_rand_mode_matches_jax_bf16(models):
    jG, gvars, G, cfg = models
    pyr = cfg.pyramid()
    noise_init = np.random.default_rng(0).standard_normal(
        (BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref, ref_vae, _ = _jax_apply(jG, gvars, key, noise_init=noise_init,
                                 mode="rand")
    _, noises = _replay(key, pyr, cfg.vae_levels, SCALE)
    cp.counts.reset()
    with torch.no_grad():
        out, vae, stats = G.apply(AMPS, noise_init=noise_init, mode="rand",
                                  train=True, noises=noises)
    assert stats is None
    assert cp.counts.plain_calls == cfg.num_layer * SCALE
    assert out.shape == (BATCH, *pyr.shape3d(SCALE), 3)
    _assert_close(vae, ref_vae)
    _assert_close(out, ref)


def test_rec_mode_matches_jax_bf16(models):
    jG, gvars, G, cfg = models
    pyr = cfg.pyramid()
    real_zero = np.tanh(np.random.default_rng(1).standard_normal(
        (BATCH, *pyr.shape3d(0), 3))).astype(np.float32)
    key = jax.random.PRNGKey(12)
    ref, ref_vae, (mu_ref, logvar_ref) = _jax_apply(
        jG, gvars, key, real_zero=real_zero, mode="rec")
    k_rep, _ = _replay(key, pyr, cfg.vae_levels, SCALE)
    eps = _bf16_normal(k_rep, mu_ref.shape)
    with torch.no_grad():
        out, vae, (mu, logvar) = G.apply(AMPS, real_zero=real_zero,
                                         mode="rec", train=True, eps=eps)
    _assert_close(mu, mu_ref)
    _assert_close(logvar, logvar_ref)
    _assert_close(vae, ref_vae)
    _assert_close(out, ref)


def test_dtypes_match_jax(models, monkeypatch):
    """Rand and rec outputs, ``vae_out``, ``mu``/``logvar`` and each
    stage's input ``x_in`` (f32 in rand mode: ``x_up + noise * amps[i]``
    with the f32 amps array, generators.py:257; bf16 in rec mode) have the
    JAX package's dtypes (``jax.eval_shape``)."""
    jG, gvars, G, cfg = models
    pyr = cfg.pyramid()
    seen = []
    inner = jgenerators._apply_bn_module

    def spy(mod, mvars, x, *args, **kw):
        if mod is jG.stage_def:
            seen.append(jnp.dtype(x.dtype))
        return inner(mod, mvars, x, *args, **kw)

    monkeypatch.setattr(jgenerators, "_apply_bn_module", spy)
    ours = []
    hooks = [stage.register_forward_pre_hook(
        lambda m, args: ours.append(args[0].dtype)) for stage in G.body]
    z = np.zeros((BATCH, *pyr.shape3d(0), cfg.latent_dim), np.float32)
    rz = np.zeros((BATCH, *pyr.shape3d(0), 3), np.float32)
    key = jax.random.PRNGKey(0)
    try:
        for kw in (dict(noise_init=z, mode="rand"),
                   dict(real_zero=rz, mode="rec")):
            (out, vae, stats), _ = jax.eval_shape(
                lambda gv, k: jG.apply(gv, jnp.asarray(AMPS), k, train=True,
                                       **kw), gvars, key)
            with torch.no_grad():
                t_out, t_vae, t_stats = G.apply(AMPS, train=True, **kw)
            for got, ref in [(t_out, out), (t_vae, vae)] + list(
                    zip(t_stats or (), stats or ())):
                assert got.dtype == BF16[jnp.dtype(ref.dtype)]
    finally:
        for h in hooks:
            h.remove()
    assert seen == [jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float32)] + [
        jnp.dtype(jnp.bfloat16)] * 2
    assert ours == [BF16[d] for d in seen]
    assert t_out.dtype == torch.bfloat16 and t_stats[0].dtype == torch.bfloat16


@pytest.mark.parametrize("size", [(5, 9, 16), (2, 4, 5)])
def test_resize_rounds_as_jax_in_bf16(size):
    """The interpolation weights in bf16 and one rounding a resized axis
    (resize.py:59-67): the same bits as the JAX package's matmuls."""
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 7, 3))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jresize.interpolate_3d(xb, size)
    got = to_public_layout(tresize.interpolate_3d(
        to_model_layout(torch.from_numpy(np.asarray(
            xb.astype(jnp.float32))).to(torch.bfloat16)), size))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.fixture(scope="module")
def critics():
    shape = (2, 4, 8, 6, 3)
    jD = JCritic(nfc=64, ker_size=3, num_layer=3, ndim=3, dtype=jnp.bfloat16)
    dvars = jax.tree_util.tree_map(np.asarray, jax.jit(jD.init)(
        jax.random.PRNGKey(0), jnp.zeros(shape)))
    D = WDiscriminator(3, 64, 3, 3, ndim=3, pconv=True, pfuse=True,
                       dtype=torch.bfloat16)
    convert.load_discriminator(D, dvars)
    x = np.tanh(np.random.default_rng(3).standard_normal(shape)).astype(
        np.float32)
    return jD, dvars, D, x


@pytest.mark.parametrize("use_kernels", [True, False])
def test_critic_matches_jax_bf16(critics, use_kernels):
    """The K2 pair and the K1 block in bf16 (their plain versions), and the
    GP's stock critic in bf16; the score is bf16 on both sides."""
    jD, dvars, D, x = critics
    ref = jax.jit(jD.apply)(dvars, x)
    assert ref.dtype == jnp.bfloat16
    cp.counts.reset()
    cf.counts.reset()
    with torch.no_grad():
        out = to_public_layout(D(to_model_layout(x), use_kernels))
    assert cf.counts.plain_calls == cp.counts.plain_calls == int(use_kernels)
    _assert_close(out, ref)


def test_critic_parameter_gradients_match_jax_bf16(critics):
    """Through K2's and K1's Functions in bf16: f32 gradients of every
    (f32) kernel and bias, within the bar of each."""
    jD, dvars, D, x = critics
    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p: jnp.mean(jD.apply({**dvars, "params": p}, x).astype(
            jnp.float32) ** 2)))(dvars["params"]))
    D.zero_grad(set_to_none=True)
    D(to_model_layout(x)).float().square().mean().backward()
    for name, m in [("head", D.head)] + [(f"block{i}", b)
                                         for i, b in enumerate(D.body)]:
        got = np.moveaxis(np.moveaxis(m.weight.grad.numpy(), 0, -1), 0, -2)
        _assert_close(torch.from_numpy(got), grads[name]["kernel"])
        _assert_close(m.bias.grad, grads[name]["bias"])


def test_make_discriminator_and_generator_take_bf16():
    cfg = _cfg(Config, pconv=True, pfuse=True)
    D = make_discriminator("WDiscriminator3D", cfg, ndim=3)
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    assert D.dtype == G.dtype == torch.bfloat16
    assert all(b.dtype == torch.bfloat16 for b in D.body)
    assert all(p.dtype == torch.float32 for p in D.parameters())
    assert all(p.dtype == torch.float32 for p in G.parameters())
    f32 = _cfg(Config, bf16=False)
    assert make_discriminator("WDiscriminator3D", f32, ndim=3).dtype is None


def test_sampler_session_honours_bf16_snapshot(models, tmp_path,
                                               monkeypatch):
    """The repaired fault: a run's ``config.json`` with ``bf16: true``
    makes the session sample in bf16, and it samples what the JAX bf16
    generator samples from the same draws (the session's own torch draws,
    replayed into the JAX generator's noise)."""
    jG, gvars, G, cfg = models
    snap_cfg = _cfg(Config)
    snap_cfg.video_path = "data/vids/wingsuit.avi"
    netG = tmp_path / "netG"
    save_generator(str(netG), G, SCALE, AMPS)
    (tmp_path / "config.json").write_text(json.dumps(
        snap_cfg.snapshot_dict()))
    scfg = Config(pconv_all=True, netG=str(netG))
    assert not scfg.bf16
    applied = apply_snapshot(scfg, str(netG), explicit=set(),
                             user_chose_source=False)
    assert "bf16" in applied and scfg.bf16
    scfg.adjust_scales()
    session = SamplerSession(scfg, batch_size=BATCH, device="cpu")
    assert session.G.dtype == torch.bfloat16

    pyr = cfg.pyramid()
    sample = session.sample_batch(torch.Generator().manual_seed(5))
    assert sample.dtype == np.float32
    # the session's draws, in its order: the latent, then stage 1's noise
    g = torch.Generator().manual_seed(5)
    noise_init = torch.randn(session.noise_shape, generator=g).numpy()
    stage_noise = torch.randn((BATCH, 3, *pyr.shape3d(2)),
                              dtype=torch.bfloat16, generator=g)
    stage_noise = stage_noise.permute(0, 2, 3, 4, 1).float().numpy()
    monkeypatch.setattr(jgenerators, "generate_noise",
                        lambda key, ref: jnp.asarray(stage_noise, ref.dtype))
    ref, _, _ = _jax_apply(jG, gvars, jax.random.PRNGKey(0),
                           noise_init=noise_init, mode="rand")
    _assert_close(torch.from_numpy(sample).to(torch.bfloat16), ref)
    assert np.array_equal(sample, sample.astype(jnp.bfloat16).astype(
        np.float32))  # bf16 values, handed out as float32
