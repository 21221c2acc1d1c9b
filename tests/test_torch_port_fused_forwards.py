"""``--fused-forwards`` through the port: ``GeneratorHPVAEGAN.apply_fused``
runs the rec and the rand forward as one batch ``[rec | rand]`` (zero
noise on the rec half, BatchNorm statistics over the combined batch,
each layer's running statistics moved once), and the GAN step runs it in
both its critic and its generator step (JAX ``generators.py:267-313``,
``steps.py:151-152, 277-283, 338-341``).

Held against the JAX package with JAX's draws injected
(``tests/torch_port_fast.py``'s bars): ``apply_fused`` in eval and in
train mode (outputs, ``mu``/``logvar`` and the moved statistics), and the
fused GAN step.  The shape gate (a ``noise_init`` whose T is not
``real_zero``'s, the ``Z_init_size`` quirk after a resume) falls back to
the unfused step, bit for bit, and ``GeneratorVAE_nb`` never fuses."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.train import optim, steps
from torch_port_runs import one_torch_thread

SCALE = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _noisy(cfg):
    return lambda idx: cfg.vae_levels <= idx + 1


@pytest.mark.parametrize("train", [False, True])
def test_apply_fused_matches_jax(train):
    jcfg, jG, gvars = fast.jax_generator(SCALE)
    cfg, G = fast.port_generator(gvars, SCALE)
    pyr = cfg.pyramid()
    _, real_zero, noise_init = fast.data(pyr, 3, SCALE, seed=51)
    key = jax.random.PRNGKey(52)
    (gen, fake, vae, (mu, logvar)), gv_new = jax.jit(
        lambda gv, k: jG.apply_fused(gv, jnp.asarray(fast.AMPS), k,
                                     real_zero, noise_init, train=train))(
        fast.copy_tree(gvars), key)
    with torch.no_grad():
        got = G.apply_fused(fast.AMPS, real_zero, noise_init, train=train,
                            eps=fast.eps_of(key, pyr, 3),
                            noises=fast.noises_of(key, pyr, 3, SCALE,
                                                  _noisy(cfg)),
                            update_stats=train)
    for g, w, what in zip(got[:3] + got[3], (gen, fake, vae, mu, logvar),
                          ("generated", "fake", "vae_out", "mu", "logvar")):
        assert tuple(g.shape) == tuple(w.shape), what
        fast.close(g.numpy(), w, what)
    if train:   # the statistics moved once, with the combined batch's
        _, ref = fast.port_generator(fast.np_tree(gv_new), SCALE)
        fast.assert_buffers_close(G, ref)


def test_fused_gan_step_matches_jax():
    over = dict(fused_forwards=True)
    jcfg, jG, gvars = fast.jax_generator(SCALE, **over)
    jD, dvars, port_critic = fast.critics(3)
    fns, opt_g_j, opt_d_j, lrs = fast.jax_steps(jcfg, jG, jD, gvars, SCALE,
                                                dvars)
    cfg, G = fast.port_generator(gvars, SCALE, **over)
    D = port_critic()
    pyr = cfg.pyramid()
    inputs = fast.data(pyr, 3, SCALE, seed=53)
    key = jax.random.PRNGKey(54)
    gv_new, dv_new, _, _, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        *inputs, jnp.asarray(fast.AMPS), key)
    # one k_fake: the fused forwards' eps and noises, in both steps
    k_fake, k_gp, _ = jax.random.split(key, 3)
    metrics = steps.gan_step(
        G, D, optim.build_g_optimizer(cfg, G, SCALE),
        optim.build_d_optimizer(cfg, D), cfg, *inputs, fast.AMPS,
        noises=fast.noises_of(k_fake, pyr, 3, SCALE, _noisy(cfg)),
        eps=fast.eps_of(k_fake, pyr, 3),
        alpha=float(jax.random.uniform(k_gp, ())))
    fast.assert_metrics_close(metrics, metrics_ref)
    _, ref = fast.port_generator(fast.np_tree(gv_new), SCALE, **over)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, max(lrs.values()))
    fast.assert_buffers_close(D, port_critic(fast.np_tree(dv_new)))


def _two_steps(G, D, cfg, inputs, flags):
    """The same GAN step (same weights, draws) with each cfg override of
    ``flags``; returns [(metrics, G)]."""
    out = []
    for over in flags:
        c = copy.copy(cfg)
        for k, v in over.items():
            setattr(c, k, v)
        g, d = copy.deepcopy(G), copy.deepcopy(D)
        m = steps.gan_step(g, d, optim.build_g_optimizer(c, g, SCALE),
                           optim.build_d_optimizer(c, d), c, *inputs,
                           fast.AMPS,
                           generator=torch.Generator().manual_seed(9))
        out.append((m, g))
    return out


def _assert_same(runs):
    (m_a, g_a), (m_b, g_b) = runs
    for name in m_a:
        assert torch.equal(m_a[name], m_b[name]), name
    for a, b in zip(g_a.state_dict().values(), g_b.state_dict().values()):
        assert torch.equal(a, b)


def test_the_shape_gate_falls_back_to_the_unfused_step():
    """A noise_init with another T than real_zero's runs unfused."""
    _, _, gvars = fast.jax_generator(SCALE)
    cfg, G = fast.port_generator(gvars, SCALE)
    _, _, port_critic = fast.critics(3)
    real, real_zero, noise_init = fast.data(cfg.pyramid(), 3, SCALE,
                                            seed=55)
    noise_init = np.concatenate([noise_init, noise_init[:, :1]], axis=1)
    runs = _two_steps(G, port_critic(), cfg, (real, real_zero, noise_init),
                      [dict(fused_forwards=True), dict(fused_forwards=False)])
    _assert_same(runs)
    # and with matching shapes the fused step is another step
    runs = _two_steps(G, port_critic(), cfg,
                      fast.data(cfg.pyramid(), 3, SCALE, seed=55),
                      [dict(fused_forwards=True), dict(fused_forwards=False)])
    assert not torch.equal(runs[0][0]["errD_fake"], runs[1][0]["errD_fake"])


def test_vae_nb_is_not_fused():
    cfg = fast.cfg_of(Config, generator="GeneratorVAE_nb")
    G = make_generator("GeneratorVAE_nb", cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    assert not G.split_forwards
    with pytest.raises(NotImplementedError):
        G.apply_fused(fast.AMPS, None, None)
    _, _, port_critic = fast.critics(3)
    _assert_same(_two_steps(
        G, port_critic(), cfg, fast.data(cfg.pyramid(), 3, SCALE, seed=56),
        [dict(fused_forwards=True), dict(fused_forwards=False)]))
