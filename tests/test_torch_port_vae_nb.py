"""``GeneratorVAE_nb`` through the port (``hpvaegan_tpu_torch``) against the
JAX package on the CPU, on the same weights (``utils/convert.py``) and
with JAX's draws injected: ``reparameterize_bern``, ``EncodeVAE_nb``,
``EncodeVAE1x1``, the generator in rec, rand and inject mode, the VAE
step with its ``kl_bern`` term and the GAN step (nfc 64 under
``--pconv-all --pfuse``, so the stages and the critic take the kernels'
routes, their plain versions here), the detach quirk, and bf16.

Tolerances: f32 ``rtol=2e-3, atol=2e-4``; parameters after a step as
``tests/test_torch_port_train_step.py`` holds them (Adam's first update is
about ``lr * sign(g)``); bf16 at the JAX package's bar, 5e-2 of
``max(|ref|, 1)`` (``tests/test_pconv.py:49-57``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models import networks as jnet
from hpvaegan_tpu.models.generators import GeneratorVAE_nb as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_hpvaegan_steps
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models import networks
from hpvaegan_tpu_torch.models.generators import (GeneratorHPVAEGAN,
                                                  to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
import torch_port_flax as flax_vars
from torch_port_runs import one_torch_thread

RTOL, ATOL = 2e-3, 2e-4
BF16_BAR = 5e-2
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=8, latent_dim=4,
            num_layer=2, enc_blocks=1, vae_levels=2,
            generator="GeneratorVAE_nb")
WIDE = dict(TINY, nfc=64, pconv=True, pconv_all=True, pfuse=True)
BATCH, SCALE = 2, 3
AMPS = [1.0, 0.3, 0.2, 0.15]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _jax_model(n_stages, **over):
    """The JAX generator and its variables: a seeded port model grown to
    ``n_stages``, as flax trees (``torch_port_flax``)."""
    jcfg = _cfg(JConfig, **over)
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    cfg = _cfg(Config, **over)
    G = make_generator("GeneratorVAE_nb", cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(n_stages):
        G.init_next_stage(gen)
    return jcfg, jG, flax_vars.generator(G)


def _port_model(gvars, **over):
    cfg = _cfg(Config, **over)
    G = make_generator("GeneratorVAE_nb", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    G.requires_grad_(True)
    return cfg, G


def _data(pyr, scale, seed):
    rng = np.random.default_rng(seed)
    real = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(scale), 3)))
    real_zero = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(0), 3)))
    return real.astype(np.float32), real_zero.astype(np.float32)


def _rec_eps(key, pyr, latent, dtype=jnp.float32):
    """The rec forward's draws under ``key`` (generators.py:361, 376-377;
    networks.py:48, 57): the normal for z_norm and the uniform for z_bern,
    shaped like mu and bern."""
    _, k_norm, k_bern = jax.random.split(key, 3)
    return (np.asarray(jax.random.normal(k_norm, (BATCH, 1, 1, 1, latent),
                                         dtype), np.float32),
            np.asarray(jax.random.uniform(k_bern, (BATCH, *pyr.shape3d(0), 1),
                                          dtype), np.float32))


def _rand_draws(key, pyr, latent, n_stages, start=0, dtype=jnp.float32):
    """The rand forward's latents (in ``noise_init``'s dtype, f32) and
    stage noises (in the stages' dtype) under ``key``
    (generators.py:361-371, 405-407): every stage from ``start`` on."""
    key, k_norm, k_bern = jax.random.split(key, 3)
    z_norm = jax.random.normal(k_norm, (BATCH, 1, 1, 1, latent))
    z_bern = jax.random.bernoulli(k_bern, 0.5,
                                  (BATCH, *pyr.shape3d(0), 1)).astype(
                                      jnp.float32)
    noises = [None] * n_stages
    for idx in range(start, n_stages):
        key, k_n = jax.random.split(key)
        noises[idx] = np.asarray(jax.random.normal(
            k_n, (BATCH, *pyr.shape3d(idx + 1), 3), dtype), np.float32)
    return (np.asarray(z_norm, np.float32),
            np.asarray(z_bern, np.float32)), noises


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _bf16_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bar = BF16_BAR * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bar, what


@pytest.mark.parametrize("training", [True, False])
def test_reparameterize_bern_matches_jax(training):
    x = jax.nn.sigmoid(jax.random.normal(jax.random.PRNGKey(1),
                                         (2, 3, 4, 5, 1)))
    key = jax.random.PRNGKey(2)
    ref = jnet.reparameterize_bern(key, x, training)
    draw = (jax.random.uniform(key, x.shape, x.dtype) if training
            else jax.random.bernoulli(key, x).astype(x.dtype))
    got = networks.reparameterize_bern(torch.tensor(np.asarray(x)), training,
                                       eps=torch.tensor(np.asarray(draw)))
    if training:
        _close(got.numpy(), ref)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        # its own draw is a 0/1 sample too
        own = networks.reparameterize_bern(
            torch.tensor(np.asarray(x)), False,
            generator=torch.Generator().manual_seed(0))
        assert set(np.unique(own.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("which", ["nb", "1x1"])
def test_encoders_match_jax(which):
    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 4, 6, 8, 3))).astype(np.float32)
    if which == "nb":
        jm = jnet.EncodeVAE_nb(latent_dim=4, nfc=8, ker_size=3, enc_blocks=1,
                               ndim=3)
        m_args = (3, 4, 8, 3, 1, 3)
        m = networks.EncodeVAE_nb(*m_args)
    else:
        jm = jnet.EncodeVAE1x1(latent_dim=4, nfc=8, ndim=3)
        m_args = (3, 4, 8, 3)
        m = networks.EncodeVAE1x1(*m_args)
    m.reset_parameters(torch.Generator().manual_seed(4))
    v = flax_vars.encoder(m)
    ref = jax.jit(jm.apply)(v, x)
    m2 = type(m)(*m_args)
    convert.load_encoder(m2, v)   # the converter reads the tree back
    for (name, a), b in zip(m.state_dict().items(),
                            m2.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    with torch.no_grad():
        got = m2(to_model_layout(x))
    assert len(got) == len(ref) == (3 if which == "nb" else 2)
    for g, r, name in zip(got, ref, ("mu", "logvar", "bern")):
        assert tuple(to_public_layout(g).shape) == r.shape, name
        _close(to_public_layout(g).numpy(), r, name)


@pytest.fixture(scope="module")
def tiny():
    return _jax_model(SCALE)


def test_generator_rec_matches_jax(tiny):
    jcfg, jG, gvars = tiny
    cfg, G = _port_model(gvars)
    pyr = cfg.pyramid()
    _, real_zero = _data(pyr, SCALE, seed=5)
    key = jax.random.PRNGKey(6)
    (out, vae, stats), _ = jax.jit(lambda gv, rz: jG.apply(
        gv, jnp.asarray(AMPS), key, real_zero=rz, mode="rec", train=True))(
        gvars, real_zero)
    with torch.no_grad():
        got, got_vae, got_stats = G.apply(
            AMPS, real_zero=real_zero, mode="rec", train=True,
            eps=_rec_eps(key, pyr, cfg.latent_dim))
    assert len(got_stats) == 3
    for a, b, name in ((got, out, "out"), (got_vae, vae, "vae"),
                       *zip(got_stats, stats, ("mu", "logvar", "bern"))):
        assert tuple(a.shape) == b.shape, name
        _close(a.numpy(), b, name)


def test_generator_rand_and_inject_match_jax(tiny):
    jcfg, jG, gvars = tiny
    cfg, G = _port_model(gvars)
    pyr = cfg.pyramid()
    noise_init = np.zeros((BATCH, *pyr.shape3d(0), cfg.latent_dim),
                          np.float32)
    key = jax.random.PRNGKey(7)
    (out, vae, _), _ = jax.jit(lambda gv: jG.apply(
        gv, jnp.asarray(AMPS), key, noise_init=noise_init, mode="rand",
        train=True))(gvars)
    latents, noises = _rand_draws(key, pyr, cfg.latent_dim, SCALE)
    with torch.no_grad():
        got, got_vae, stats = G.apply(
            AMPS, noise_init=noise_init, noise_init_norm=latents[0],
            noise_init_bern=latents[1], mode="rand", train=True,
            noises=noises)
    assert stats is None and len(noises) == SCALE  # noise at every stage
    _close(got.numpy(), out, "rand out")
    _close(got_vae.numpy(), vae, "rand vae")
    # its own draws: the geometry of the JAX draws, Bernoulli 0/1
    z_norm, z_bern = G.draw_latents(torch.tensor(noise_init),
                                    torch.Generator().manual_seed(1))
    assert tuple(z_norm.shape) == latents[0].shape
    assert tuple(z_bern.shape) == latents[1].shape
    assert set(np.unique(z_bern.numpy())) <= {0.0, 1.0}

    start = 1
    x_init, _ = _data(pyr, start, seed=8)
    (inj, _, _), _ = jax.jit(lambda gv, x: jG.apply(
        gv, jnp.asarray(AMPS), key, noise_init=noise_init,
        sample_init=(start, x), mode="rand", train=True))(gvars, x_init)
    latents, noises = _rand_draws(key, pyr, cfg.latent_dim, SCALE, start)
    with torch.no_grad():
        got, _, _ = G.apply(AMPS, noise_init=noise_init,
                            noise_init_norm=latents[0],
                            noise_init_bern=latents[1],
                            sample_init=(start, x_init), mode="rand",
                            train=True, noises=noises)
    _close(got.numpy(), inj, "inject")


def test_generator_bf16_matches_jax():
    jcfg, jG, gvars = _jax_model(2, bf16=True)
    cfg, G = _port_model(gvars, bf16=True)
    assert G.dtype == torch.bfloat16
    pyr = cfg.pyramid()
    _, real_zero = _data(pyr, 2, seed=9)
    key = jax.random.PRNGKey(10)
    amps = jnp.asarray(AMPS[:3])
    (out, _, stats), _ = jax.jit(lambda gv, rz: jG.apply(
        gv, amps, key, real_zero=rz, mode="rec", train=True))(gvars,
                                                              real_zero)
    noise_init = np.zeros((BATCH, *pyr.shape3d(0), cfg.latent_dim),
                          np.float32)
    (rand, _, _), _ = jax.jit(lambda gv: jG.apply(
        gv, amps, key, noise_init=noise_init, mode="rand", train=True))(
        gvars)
    assert out.dtype == rand.dtype == jnp.bfloat16
    with torch.no_grad():
        got, _, got_stats = G.apply(
            AMPS[:3], real_zero=real_zero, mode="rec", train=True,
            eps=_rec_eps(key, pyr, cfg.latent_dim, jnp.bfloat16))
        latents, noises = _rand_draws(key, pyr, cfg.latent_dim, 2,
                                      dtype=jnp.bfloat16)
        got_rand, _, _ = G.apply(
            AMPS[:3], noise_init=noise_init, noise_init_norm=latents[0],
            noise_init_bern=latents[1], mode="rand", train=True,
            noises=noises)
    assert got.dtype == got_rand.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), out, "bf16 rec")
    _bf16_close(got_rand.float().numpy(), rand, "bf16 rand")
    for a, b, name in zip(got_stats, stats, ("mu", "logvar", "bern")):
        _bf16_close(a.float().numpy(), b, name)


def _assert_params_after_adam(module, ref, lr_max):
    want = dict(ref.named_parameters())
    off = total = 0
    for name, p in module.named_parameters():
        got, exp = p.detach().numpy(), want[name].detach().numpy()
        diff = np.abs(got - exp)
        assert diff.max() <= 2 * lr_max * 1.01 + ATOL, (name, diff.max())
        off += int(np.sum(diff > ATOL + RTOL * np.abs(exp)))
        total += diff.size
    assert off <= 0.005 * total, (off, total)


def _assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        _close(buf.numpy(), want[name].numpy(), name)


def _jax_steps(jcfg, jG, jD, gvars, scale, dvars=None):
    pview = joptim.gparams_view(gvars)
    ml, bl, lrs = joptim.hpvaegan_group_plan(jcfg, scale, len(gvars["body"]))
    tx_g, opt_g = joptim.build_g_optimizer(jcfg, pview, ml, bl, lrs,
                                           jcfg.grad_clip)
    tx_d = opt_d = None
    if dvars is not None:
        tx_d, opt_d = joptim.build_d_optimizer(jcfg, dvars["params"])
    fns = make_hpvaegan_steps(jG, jD, jcfg, tx_g, tx_d, group_plan=(ml, bl))
    return fns, opt_g, opt_d, lrs


def test_vae_step_with_kl_bern_matches_jax():
    scale = 1
    jcfg, jG, gvars = _jax_model(scale)
    fns, opt_g_j, _, lrs = _jax_steps(jcfg, jG, None, gvars, scale)
    cfg, G = _port_model(gvars)
    pyr = cfg.pyramid()
    real, real_zero = _data(pyr, scale, seed=11)
    key = jax.random.PRNGKey(12)
    amps = AMPS[:scale + 1]
    gv_new, _, metrics_ref = fns["vae_step"](_copy(gvars), opt_g_j, real,
                                             real_zero, jnp.asarray(amps),
                                             key)
    opt_g = optim.build_g_optimizer(cfg, G, scale)
    metrics = steps.vae_step(G, opt_g, cfg, real, real_zero, amps,
                             eps=_rec_eps(key, pyr, cfg.latent_dim))
    for name, value in metrics_ref.items():
        _close(float(metrics[name]), float(value), name)
    _, ref = _port_model(_np(gv_new))
    _assert_buffers_close(G, ref)
    _assert_params_after_adam(G, ref, max(lrs.values()))
    # the KL holds the Bernoulli term: without it the step's KL differs
    with torch.no_grad():
        _, _, (mu, logvar, bern) = G.apply(
            amps, real_zero=real_zero, mode="rec", train=True,
            eps=_rec_eps(key, pyr, cfg.latent_dim))
    assert float(steps.kl_bern_criterion(bern)) > 0


def test_gan_step_matches_jax():
    """nfc 64 under --pconv --pconv-all --pfuse: the stages route K1 and
    the critic K2 (their plain versions on the CPU)."""
    jcfg, jG, gvars = _jax_model(SCALE, **WIDE)
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3)
    pyr = jcfg.pyramid()
    D0 = WDiscriminator(3, 64, 3, jcfg.num_layer, ndim=3)
    D0.reset_parameters(torch.Generator().manual_seed(13))
    dvars = flax_vars.critic(D0)
    fns, opt_g_j, opt_d_j, lrs = _jax_steps(jcfg, jG, jD, gvars, SCALE,
                                            dvars)
    cfg, G = _port_model(gvars, **WIDE)
    D = WDiscriminator(3, 64, 3, cfg.num_layer, ndim=3, pconv=True,
                       pfuse=True)
    convert.load_discriminator(D, dvars)
    real, real_zero = _data(pyr, SCALE, seed=14)
    noise_init = np.random.default_rng(15).standard_normal(
        (BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    amps = AMPS[:SCALE + 1]
    gv_new, dv_new, _, _, metrics_ref = fns["gan_step"](
        _copy(gvars), _copy(dvars), opt_g_j, opt_d_j, real, real_zero,
        noise_init, jnp.asarray(amps), key)

    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    latents, noises = _rand_draws(k_fake, pyr, cfg.latent_dim, SCALE)
    cp.counts.reset()
    cf.counts.reset()
    metrics = steps.gan_step(
        G, D, optim.build_g_optimizer(cfg, G, SCALE),
        optim.build_d_optimizer(cfg, D), cfg, real, real_zero, noise_init,
        amps, noises=noises, eps=_rec_eps(k_rec, pyr, cfg.latent_dim),
        alpha=float(jax.random.uniform(k_gp, ())), latents=latents)
    # the stages' K1 convs and the critic's K2 pair ran their plain versions
    assert cf.counts.plain_calls == 2 and cp.counts.plain_calls > 0
    for name, value in metrics_ref.items():
        _close(float(metrics[name]), float(value), name)
    _, G_ref = _port_model(_np(gv_new), **WIDE)
    _assert_buffers_close(G, G_ref)
    _assert_params_after_adam(G, G_ref, max(lrs.values()))


@pytest.mark.parametrize("generator", ["GeneratorVAE_nb",
                                       "GeneratorHPVAEGAN"])
def test_detach_ignores_train_all(generator):
    """GeneratorVAE_nb cuts the gradient at ``vae_levels`` even under
    ``--train-all`` (networks_3d.py:470-471, PARITY.md); the core model
    lets it through."""
    cfg = _cfg(Config, train_all=True, generator=generator)
    G = make_generator(generator, cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(17)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    pyr = cfg.pyramid()
    real, real_zero = _data(pyr, SCALE, seed=18)
    out, _, _ = G.apply(AMPS, real_zero=real_zero, mode="rec", train=True,
                        generator=gen)
    noise = torch.randn((BATCH, *pyr.shape3d(0), cfg.latent_dim),
                        generator=gen)
    fake, _, _ = G.apply(AMPS, noise_init=noise, mode="rand", train=True,
                         generator=gen)
    ((out - torch.tensor(real)).square().mean() + fake.mean()).backward()
    below = [G.encode, G.decoder, *G.body[:cfg.vae_levels - 1]]
    reached = [p.grad is not None and bool(p.grad.abs().sum() > 0)
               for m in below for p in m.parameters()]
    if generator == "GeneratorVAE_nb":
        assert not any(reached)
    else:
        assert all(reached)
    assert all(p.grad is not None for p in G.body[-1].parameters())
    assert isinstance(G, GeneratorHPVAEGAN)
