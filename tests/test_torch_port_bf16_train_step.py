"""The training steps under ``--bf16``: ``calibrate``, ``vae_step`` and
``gan_step`` of the port against the JAX package's jitted steps with
``bf16=True``, on a tiny nfc-64 model under pconv_all + pfuse (the bf16
kernels' plain versions on the CPU), from the same weights and with the
JAX draws replayed in bf16 where the JAX package draws in bf16 (the
reparameterization ``eps`` and the stage noises; the GP's alpha is f32).
Also: every metric has the JAX package's dtype, and ``train_scale`` runs
a bf16 config end to end.

Tolerances, in units of bf16 rounding (tests/test_torch_port_bf16_models.py
says why the two sides may round to neighbouring bf16 values): metrics,
BatchNorm running statistics and spectral u/v within the JAX package's
bf16 bar, 5e-2 of max(|ref|, 1) (tests/test_pconv.py:49-57).  Parameters
after one step: Adam's first update is about ``lr * sign(g)``, so an
element whose gradient is near zero may take the other sign in the other
framework and differ by up to ``2 * lr``; bf16 gradients carry ~2**-8
relative noise, so more of them do than in f32.  Every parameter is held
within ``2 * lr`` of JAX's, and at most 2% of the elements may differ by
more than the bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_hpvaegan_steps
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.train.trainer import train_scale
from hpvaegan_tpu_torch.utils import convert
from torch_port_runs import one_torch_thread

BAR = 5e-2
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True,
            pfuse=True, bf16=True)
BATCH = 2
VAE_SCALE, GAN_SCALE = 1, 3
AMPS = [1.0, 0.3, 0.2, 0.15]
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The nfc-64 model on a tiny pyramid: one intra-op thread runs its
    small ops several times faster, and no worker oversubscribes."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_models():
    """JAX bf16 generator variables at 1 and 3 stages, bf16 critic
    variables (lax path, the same tree as the kernel path)."""
    jcfg = _cfg(JConfig)
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    grown = []
    for i in range(GAN_SCALE):
        gvars = jG.init_next_stage(gvars, jax.random.fold_in(key, 100 + i))
        grown.append(_np(gvars))
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3,
                 dtype=jnp.bfloat16)
    shape = (BATCH, *jcfg.pyramid().shape3d(GAN_SCALE), 3)
    dvars = _np(jax.jit(jD.init)(jax.random.fold_in(key, 7),
                                 jnp.zeros(shape)))
    return jcfg, jG, {VAE_SCALE: grown[0], GAN_SCALE: grown[-1]}, jD, dvars


def _port_generator(gvars, scale):
    cfg = _cfg(Config)
    cfg.scale_idx = scale
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    G.requires_grad_(True)
    return cfg, G


def _port_critic(dvars):
    D = WDiscriminator(3, 64, 3, TINY["num_layer"], ndim=3, pconv=True,
                       pfuse=True, dtype=torch.bfloat16)
    convert.load_discriminator(D, dvars)
    return D


def _data(pyr, scale, seed):
    rng = np.random.default_rng(seed)
    real = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(scale), 3)))
    real_zero = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(0), 3)))
    return real.astype(np.float32), real_zero.astype(np.float32)


def _bf16_normal(key, shape) -> np.ndarray:
    return np.asarray(jax.random.normal(key, shape, jnp.bfloat16).astype(
        jnp.float32))


def _eps_of(key, pyr, latent):
    """The bf16 reparameterization draw of a rec forward keyed ``key``
    (generators.py:174, networks.py:48)."""
    _, k_rep = jax.random.split(key)
    return _bf16_normal(k_rep, (BATCH, *pyr.shape3d(0), latent))


def _noises_of(key, pyr, vae_levels, n_stages):
    """The bf16 stage noises of a rand forward keyed ``key``
    (generators.py:174, 255-256; generate_noise takes x_up's dtype)."""
    key, _ = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        if vae_levels <= idx + 1:
            key, k_n = jax.random.split(key)
            noises.append(_bf16_normal(k_n,
                                       (BATCH, *pyr.shape3d(idx + 1), 3)))
        else:
            noises.append(None)
    return noises


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


def _close(got, ref, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(got - ref)))
    assert err <= BAR * scale, (name, err, BAR * scale)


def _assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        _close(buf.numpy(), want[name].numpy(), name)


def _assert_params_after_adam(module, ref, lr_max):
    want = dict(ref.named_parameters())
    off = total = 0
    for name, p in module.named_parameters():
        got, exp = p.detach().numpy(), want[name].detach().numpy()
        diff = np.abs(got - exp)
        assert diff.max() <= 2 * lr_max * 1.01 + 1e-6, (name, diff.max())
        off += int(np.sum(diff > BAR * np.maximum(np.abs(exp), 1e-3)))
        total += diff.size
    assert off <= 0.02 * total, (off, total)


def _assert_metrics_match(got, ref):
    """Each metric within the bar, and with the JAX metric's dtype (the
    critic's means and the KL bf16; the MSEs, the GP and the totals f32)."""
    assert set(got) == set(ref)
    for name, value in ref.items():
        assert got[name].dtype == DTYPES[jnp.dtype(value.dtype)], name
        _close(float(got[name]), float(value), name)


def test_calibrate_matches_jax_bf16(jax_models):
    jcfg, jG, gv, _, _ = jax_models
    gvars = gv[GAN_SCALE]
    fns, _, _, _ = _jax_steps(jcfg, jG, None, gvars, GAN_SCALE)
    cfg, G = _port_generator(gvars, GAN_SCALE)
    pyr = cfg.pyramid()
    real, real_zero = _data(pyr, GAN_SCALE, seed=1)
    key = jax.random.PRNGKey(21)
    amps = AMPS[:GAN_SCALE] + [0.0]
    rmse_ref, gv_new = fns["calibrate"](_copy(gvars), real, real_zero,
                                        jnp.asarray(amps), key)
    rmse = steps.calibrate(G, real, real_zero, amps,
                           eps=_eps_of(key, pyr, cfg.latent_dim))
    assert rmse.dtype == DTYPES[jnp.dtype(rmse_ref.dtype)] == torch.float32
    _close(float(rmse), float(rmse_ref), "rmse")
    _, ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, ref)  # BN statistics, from the f32 BN input


def test_vae_step_matches_jax_bf16(jax_models):
    jcfg, jG, gv, _, _ = jax_models
    gvars = gv[VAE_SCALE]
    fns, opt_g_j, _, lrs = _jax_steps(jcfg, jG, None, gvars, VAE_SCALE)
    cfg, G = _port_generator(gvars, VAE_SCALE)
    pyr = cfg.pyramid()
    real, real_zero = _data(pyr, VAE_SCALE, seed=2)
    key = jax.random.PRNGKey(22)
    amps = AMPS[:VAE_SCALE + 1]
    gv_new, _, metrics_ref = fns["vae_step"](_copy(gvars), opt_g_j, real,
                                             real_zero, jnp.asarray(amps),
                                             key)
    opt_g = optim.build_g_optimizer(cfg, G, VAE_SCALE)
    cp.counts.reset()
    metrics = steps.vae_step(G, opt_g, cfg, real, real_zero, amps,
                             eps=_eps_of(key, pyr, cfg.latent_dim))
    assert cp.counts.plain_calls > 0
    _assert_metrics_match(metrics, metrics_ref)
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in G.parameters())
    _, ref = _port_generator(_np(gv_new), VAE_SCALE)
    _assert_buffers_close(G, ref)  # BN statistics and the encoder's u/v
    _assert_params_after_adam(G, ref, max(lrs.values()))


def test_gan_step_matches_jax_bf16(jax_models):
    """Scale 3 with vae_levels 2: stage 2 frozen but reached by the
    gradient, stage 3 trains; one K2 pair in the bf16 critic; the GP on
    the stock bf16 critic with f32 interpolates."""
    jcfg, jG, gv, jD, dvars = jax_models
    gvars = gv[GAN_SCALE]
    fns, opt_g_j, opt_d_j, lrs = _jax_steps(jcfg, jG, jD, gvars, GAN_SCALE,
                                            dvars)
    cfg, G = _port_generator(gvars, GAN_SCALE)
    D = _port_critic(dvars)
    pyr = cfg.pyramid()
    real, real_zero = _data(pyr, GAN_SCALE, seed=3)
    noise_init = np.random.default_rng(4).standard_normal(
        (BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    amps = AMPS[:GAN_SCALE + 1]
    gv_new, dv_new, _, _, metrics_ref = fns["gan_step"](
        _copy(gvars), _copy(dvars), opt_g_j, opt_d_j, real, real_zero,
        noise_init, jnp.asarray(amps), key)

    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    opt_g = optim.build_g_optimizer(cfg, G, GAN_SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    cp.counts.reset()
    cf.counts.reset()
    metrics = steps.gan_step(
        G, D, opt_g, opt_d, cfg, real, real_zero, noise_init, amps,
        noises=_noises_of(k_fake, pyr, cfg.vae_levels, GAN_SCALE),
        eps=_eps_of(k_rec, pyr, cfg.latent_dim),
        alpha=float(jax.random.uniform(k_gp, ())))
    assert cf.counts.plain_calls == 2 and cf.counts.bf16_launches == 0
    _assert_metrics_match(metrics, metrics_ref)
    _, G_ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, G_ref)
    _assert_params_after_adam(G, G_ref, max(lrs.values()))
    D_ref = _port_critic(_np(dv_new))
    _assert_buffers_close(D, D_ref)  # the critic's u/v
    _assert_params_after_adam(D, D_ref, cfg.lr_d)


def test_train_scale_runs_bf16_on_the_cpu():
    """``train_scale`` takes a bf16 config end to end: a VAE scale, then a
    GAN scale whose bf16 critic is made by the trainer; finite metrics,
    f32 parameters."""
    cfg = _cfg(Config, niter=1)
    cfg.Noise_Amps = [1.0]
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen).init_next_stage(gen)
    pyr = cfg.pyramid()

    def batches(scale):
        while True:
            yield _data(pyr, scale, 10 * scale)

    cfg.scale_idx = 1
    _, D, hist = train_scale(cfg, G, batches(1))
    assert D is None and hist[0]["kl_loss"].dtype == torch.bfloat16
    G.init_next_stage()
    cfg.scale_idx = 2
    cf.counts.reset()
    _, D, hist = train_scale(cfg, G, batches(2))
    assert D.dtype == torch.bfloat16 and cf.counts.plain_calls == 2
    assert hist[0]["errD_real"].dtype == torch.bfloat16
    assert all(np.isfinite(float(v)) for v in hist[0].values())
    assert len(cfg.Noise_Amps) == 3 and all(a > 0 for a in cfg.Noise_Amps)
    assert all(p.dtype == torch.float32 for p in G.parameters())
