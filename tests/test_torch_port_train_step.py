"""The training slice as a whole: ``calibrate``, ``vae_step`` and
``gan_step`` of the port (``hpvaegan_tpu_torch/train/steps.py``) against
the JAX package's jitted steps on a tiny nfc-64 model under pconv_all +
pfuse (the kernels' plain versions on the CPU), from the same weights and
with JAX's draws replayed: the reparameterization ``eps``, the stage
noises, the GP's alpha.  Also the optimizer (group plan, optax's clip over
frozen gradients, Adam) and ``train_scale``.

Tolerances: metrics, BatchNorm running statistics and spectral u/v at the
f32 bar rtol 2e-3 / atol 2e-4.  Parameters after one step: Adam's first
update is ``lr * g / (|g| + eps)``, i.e. about ``lr * sign(g)``, so an
element whose gradient is near zero may take the other sign in the other
framework and differ by up to ``2 * lr``.  Every parameter is held within
``2 * lr`` of JAX's, and at most 0.5% of the elements may differ by more
than the f32 bar."""
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

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True,
            pfuse=True)
BATCH = 2
VAE_SCALE, GAN_SCALE = 1, 3
AMPS = [1.0, 0.3, 0.2, 0.15]


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


@pytest.fixture(scope="module")
def jax_models():
    """JAX generator variables at 1 and 3 stages, critic variables (lax
    path, same tree as the kernel path), and the JAX config."""
    jcfg = _cfg(JConfig)
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    grown = []
    for i in range(GAN_SCALE):
        gvars = jG.init_next_stage(gvars, jax.random.fold_in(key, 100 + i))
        grown.append(_np(gvars))
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3)
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
                       pfuse=True)
    convert.load_discriminator(D, dvars)
    return D


def _data(pyr, scale, seed):
    rng = np.random.default_rng(seed)
    real = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(scale), 3)))
    real_zero = np.tanh(rng.standard_normal((BATCH, *pyr.shape3d(0), 3)))
    return real.astype(np.float32), real_zero.astype(np.float32)


def _eps_of(key, pyr, latent):
    """The reparameterization draw of a rec forward keyed ``key``
    (generators.py:174)."""
    _, k_rep = jax.random.split(key)
    return np.asarray(jax.random.normal(k_rep, (BATCH, *pyr.shape3d(0),
                                                latent)))


def _noises_of(key, pyr, vae_levels, n_stages):
    """The stage noises of a rand forward keyed ``key``
    (generators.py:174, 255-256)."""
    key, _ = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        if vae_levels <= idx + 1:
            key, k_n = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(
                k_n, (BATCH, *pyr.shape3d(idx + 1), 3))))
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


def _assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


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


def _assert_metrics_close(got, ref):
    for name, value in ref.items():
        np.testing.assert_allclose(float(got[name]), float(value),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_calibrate_matches_jax(jax_models):
    jcfg, jG, gv, jD, _ = jax_models
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
    np.testing.assert_allclose(float(rmse), float(rmse_ref), rtol=RTOL)
    _, ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, ref)  # BN statistics moved as flax moves them


def test_vae_step_matches_jax(jax_models):
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
    assert cp.counts.fwd_launches == cp.counts.dw_launches == 0
    assert cp.counts.plain_calls > 0
    _assert_metrics_close(metrics, metrics_ref)
    _, ref = _port_generator(_np(gv_new), VAE_SCALE)
    _assert_buffers_close(G, ref)  # BN statistics and the encoder's u/v
    _assert_params_after_adam(G, ref, max(lrs.values()))


def test_gan_step_matches_jax(jax_models):
    """Scale 3 with vae_levels 2: stage 2 is frozen but reached by the
    gradient, stage 3 trains; one K2 pair in the critic."""
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
    # K2: critic step + generator step; the GP runs stock convs only
    assert cf.counts.plain_calls == 2 and cf.counts.launches == 0
    assert all(p.requires_grad for p in D.parameters())  # unfrozen again
    _assert_metrics_close(metrics, metrics_ref)
    _, G_ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, G_ref)
    _assert_params_after_adam(G, G_ref, max(lrs.values()))
    D_ref = _port_critic(_np(dv_new))
    _assert_buffers_close(D, D_ref)  # the critic's u/v
    _assert_params_after_adam(D, D_ref, cfg.lr_d)


@pytest.mark.parametrize("scale,n_body,train_all",
                         [(0, 0, False), (1, 1, False), (3, 3, False),
                          (5, 5, False), (1, 1, True), (4, 4, True)])
def test_group_plan_matches_jax(scale, n_body, train_all):
    ours = optim.hpvaegan_group_plan(_cfg(Config, train_all=train_all,
                                          train_depth=2), scale, n_body)
    theirs = joptim.hpvaegan_group_plan(_cfg(JConfig, train_all=train_all,
                                             train_depth=2), scale, n_body)
    assert ours == theirs


def test_clip_and_adam_match_optax(jax_models):
    """JAX's gradients fed to the port's clip + Adam give JAX's
    parameters to 1e-6 over three steps: two clipped, one not.  The frozen
    stages' gradients are non-zero and enter the clip norm, as in the JAX
    package (clip before set_to_zero)."""
    jcfg, _, gv, _, _ = jax_models
    gvars = gv[GAN_SCALE]
    pview = joptim.gparams_view(gvars)
    ml, bl, lrs = joptim.hpvaegan_group_plan(jcfg, GAN_SCALE, GAN_SCALE)
    tx, state = joptim.build_g_optimizer(jcfg, pview, ml, bl, lrs,
                                         jcfg.grad_clip)
    cfg, G = _port_generator(gvars, GAN_SCALE)
    opt = optim.build_g_optimizer(cfg, G, GAN_SCALE)
    rng = np.random.default_rng(5)
    params = pview
    norms = []
    for scale in (0.1, 1e-4, 0.05):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), pview)
        upd, state = tx.update(grads, state, params)
        params = _np(jax.tree_util.tree_map(lambda p, u: p + u, params, upd))
        # the same gradients in the port's layouts, through the converter
        G_grads = _port_generator(joptim.merge_gparams(gvars, grads),
                                  GAN_SCALE)[1]
        for p, g in zip(G.parameters(), G_grads.parameters()):
            p.grad = g.detach().clone()
        norms.append(float(optim.clip_grad_norm_(G.parameters(),
                                                 cfg.grad_clip)))
        opt.step()
    assert norms[0] > cfg.grad_clip > norms[1] and norms[2] > cfg.grad_clip
    _, ref = _port_generator(joptim.merge_gparams(gvars, params), GAN_SCALE)
    want = dict(ref.named_parameters())
    for name, p in G.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_train_scale_vae_then_gan_on_the_cpu():
    """The entry point: iteration-0 calibration appends the scale's amp,
    then niter steps; the GAN scale warm-starts its critic from the
    previous GAN scale's."""
    cfg = _cfg(Config, niter=2)
    cfg.Noise_Amps = [1.0]
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen).init_next_stage(gen)
    pyr = cfg.pyramid()

    def batches(scale):
        seed = 10 * scale
        while True:
            seed += 1
            yield _data(pyr, scale, seed)

    events = []
    cfg.scale_idx = 1
    _, D, hist = train_scale(cfg, G, batches(1), callback=lambda e, i, m:
                             events.append((e, i)))
    assert D is None and len(hist) == 2 and len(cfg.Noise_Amps) == 2
    assert events == [("calibrate", -1), ("step", 0), ("step", 1)]
    assert all(np.isfinite(float(m["loss"])) for m in hist)
    Ds = []
    for scale in (2, 3):
        G.init_next_stage()
        cfg.scale_idx = scale
        _, D, hist = train_scale(cfg, G, batches(scale),
                                 D_prev=Ds[-1] if Ds else None)
        Ds.append(D)
        assert set(hist[0]) == {"loss", "rec_loss", "errG", "errD_real",
                                "errD_fake", "gradient_penalty"}
        assert all(np.isfinite(float(v)) for m in hist for v in m.values())
    assert len(cfg.Noise_Amps) == 4 and all(a > 0 for a in cfg.Noise_Amps)


def test_batchnorm_running_stats_follow_flax():
    """flax's rule: momentum 0.9 and the BIASED batch variance.  On a
    16-voxel batch torch's unbiased variance would differ by 1/15, far
    above the bar; sampling (no update asked) leaves the buffers alone."""
    from hpvaegan_tpu.models.blocks import ConvBlock as JBlock
    from hpvaegan_tpu_torch.models.blocks import ConvBlock
    from hpvaegan_tpu_torch.models.generators import to_model_layout
    x = np.random.default_rng(6).standard_normal((2, 2, 2, 4, 3)).astype(
        np.float32)
    jblock = JBlock(features=8, ker_size=3, padding=1, ndim=3)
    v = _np(jax.jit(lambda k, x: jblock.init(k, x, True))(
        jax.random.PRNGKey(3), x))
    v["batch_stats"]["norm"]["var"] = np.full(8, 2.0, np.float32)
    _, upd = jax.jit(lambda v, x: jblock.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    block = ConvBlock(3, 8, 3, 1, ndim=3)
    convert.load_conv_block(block, v["params"], v["batch_stats"])
    with torch.no_grad():
        block(to_model_layout(x), True)
        np.testing.assert_array_equal(block.norm.running_var.numpy(), 2.0)
        block(to_model_layout(x), True, update_stats=True)
    for ours, theirs in ((block.norm.running_mean, "mean"),
                         (block.norm.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(),
                                   upd["batch_stats"]["norm"][theirs],
                                   rtol=1e-5, atol=1e-6)
