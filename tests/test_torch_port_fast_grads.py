"""``--fast-grads`` through the port (``optim.freeze_frozen``): the VAE and
the GAN step against the JAX package's ``make_hpvaegan_steps`` with
``fast_grads`` on a tiny 3D model, from the same weights and with JAX's
draws injected (``tests/torch_port_fast.py``).

The clip is made to engage (``grad_clip`` 1e-3): then the trainable
gradients after the clip have the global norm ``grad_clip`` exactly when
the frozen stages' gradients are absent from the norm, as in the JAX
package's fast path (``steps.py:119-124``), and Adam's first moments
(``(1 - b1)`` times the clipped gradients) agree with JAX's.  Without
the flag the frozen stage reached by the gradient enters the norm, as
the reference's clip does.  Tolerances: ``tests/torch_port_fast.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch.train import optim, steps
from torch_port_runs import one_torch_thread

CLIP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _trainable_grad_norm(G, opt):
    grads = [p.grad for g in opt.param_groups for p in g["params"]
             if p.grad is not None]
    return float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads])))


def _frozen(G, opt):
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    return [p for p in G.parameters() if id(p) not in in_opt]


def test_vae_step_fast_grads_matches_jax():
    """Scale 2 under --vae-levels 3: the encoder, decoder and stage 1
    train, stage 0 is frozen but reached by the gradient."""
    scale, over = 2, dict(vae_levels=3, grad_clip=CLIP, fast_grads=True)
    jcfg, jG, gvars = fast.jax_generator(scale, **over)
    fns, opt_g_j, _, lrs = fast.jax_steps(jcfg, jG, None, gvars, scale)
    cfg, G = fast.port_generator(gvars, scale, **over)
    pyr = cfg.pyramid()
    real, real_zero, _ = fast.data(pyr, 3, scale, seed=31)
    key = jax.random.PRNGKey(32)
    amps = fast.AMPS[:scale + 1]
    gv_new, opt_g_j, metrics_ref = fns["vae_step"](
        fast.copy_tree(gvars), opt_g_j, real, real_zero, jnp.asarray(amps),
        key)
    opt_g = optim.build_g_optimizer(cfg, G, scale)
    optim.freeze_frozen(cfg, G, scale)
    frozen = _frozen(G, opt_g)
    assert frozen and all(not p.requires_grad for p in frozen)
    metrics = steps.vae_step(G, opt_g, cfg, real, real_zero, amps,
                             eps=fast.eps_of(key, pyr, 3))
    assert all(p.grad is None for p in frozen)
    np.testing.assert_allclose(_trainable_grad_norm(G, opt_g), CLIP,
                               rtol=1e-5)
    fast.assert_metrics_close(metrics, metrics_ref)
    _, ref = fast.port_generator(fast.np_tree(gv_new), scale, **over)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, max(lrs.values()))
    fast.assert_first_moments_match(G, opt_g, gvars, opt_g_j, scale,
                                    **over)


def _gan_setup(fast_grads: bool):
    scale = 3
    over = dict(grad_clip=CLIP, fast_grads=fast_grads)
    jcfg, jG, gvars = fast.jax_generator(scale, **over)
    jD, dvars, port_critic = fast.critics(3)
    fns, opt_g_j, opt_d_j, lrs = fast.jax_steps(jcfg, jG, jD, gvars, scale,
                                                dvars)
    cfg, G = fast.port_generator(gvars, scale, **over)
    return scale, over, gvars, dvars, fns, opt_g_j, opt_d_j, lrs, cfg, G, \
        port_critic()


def _gan_draws(key, pyr, cfg, scale):
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    return dict(
        noises=fast.noises_of(k_fake, pyr, 3, scale,
                              lambda i: cfg.vae_levels <= i + 1),
        eps=fast.eps_of(k_rec, pyr, 3),
        alpha=float(jax.random.uniform(k_gp, ())))


def test_gan_step_fast_grads_matches_jax():
    """Scale 3 under --vae-levels 2: stage 2 trains; stage 1 is frozen and
    reached by the gradient (the detach is before it), the encoder and
    decoder frozen and not reached."""
    (scale, over, gvars, dvars, fns, opt_g_j, opt_d_j, lrs, cfg, G,
     D) = _gan_setup(True)
    pyr = cfg.pyramid()
    real, real_zero, noise_init = fast.data(pyr, 3, scale, seed=33)
    key = jax.random.PRNGKey(34)
    amps = fast.AMPS[:scale + 1]
    gv_new, dv_new, opt_g_j, _, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        real, real_zero, noise_init, jnp.asarray(amps), key)
    opt_g = optim.build_g_optimizer(cfg, G, scale)
    optim.freeze_frozen(cfg, G, scale)
    frozen = _frozen(G, opt_g)
    metrics = steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D),
                             cfg, real, real_zero, noise_init, amps,
                             **_gan_draws(key, pyr, cfg, scale))
    assert all(p.grad is None for p in frozen)
    assert all(p.grad is not None for p in G.body[2].parameters())
    np.testing.assert_allclose(_trainable_grad_norm(G, opt_g), CLIP,
                               rtol=1e-5)
    fast.assert_metrics_close(metrics, metrics_ref)
    _, ref = fast.port_generator(fast.np_tree(gv_new), scale, **over)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, max(lrs.values()))
    fast.assert_first_moments_match(G, opt_g, gvars, opt_g_j, scale,
                                    **over)


def test_without_fast_grads_the_frozen_stage_enters_the_clip():
    """The reference's clip: stage 1's gradients (frozen, reached) are in
    the norm, so the trainable ones end below the bound, and the first
    moments still agree with the JAX step without the flag."""
    (scale, over, gvars, dvars, fns, opt_g_j, opt_d_j, lrs, cfg, G,
     D) = _gan_setup(False)
    pyr = cfg.pyramid()
    real, real_zero, noise_init = fast.data(pyr, 3, scale, seed=35)
    key = jax.random.PRNGKey(36)
    amps = fast.AMPS[:scale + 1]
    _, _, opt_g_j, _, _ = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        real, real_zero, noise_init, jnp.asarray(amps), key)
    opt_g = optim.build_g_optimizer(cfg, G, scale)
    steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D), cfg, real,
                   real_zero, noise_init, amps,
                   **_gan_draws(key, pyr, cfg, scale))
    assert all(p.grad is not None for p in G.body[1].parameters())
    assert _trainable_grad_norm(G, opt_g) < CLIP * (1 - 1e-3)
    fast.assert_first_moments_match(G, opt_g, gvars, opt_g_j, scale,
                                    **over)


def test_the_trainer_thaws_the_generator_at_the_scale_end():
    """train_scale freezes the plan's frozen groups for its scale only."""
    from hpvaegan_tpu_torch.train.trainer import train_scale
    scale = 3
    jcfg, jG, gvars = fast.jax_generator(scale, fast_grads=True)
    cfg, G = fast.port_generator(gvars, scale, fast_grads=True, niter=1)
    cfg.Noise_Amps = fast.AMPS[:scale]
    pyr = cfg.pyramid()
    seen = []

    def batches():
        while True:
            seen.append([p.requires_grad for p in G.body[0].parameters()])
            yield fast.data(pyr, 3, scale, seed=37)[:2]

    _, _, hist = train_scale(cfg, G, batches())
    assert len(hist) == 1 and np.isfinite(float(hist[0]["loss"]))
    assert seen and not any(any(s) for s in seen)   # frozen while training
    assert all(p.requires_grad for p in G.parameters())
