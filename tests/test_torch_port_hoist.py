"""``--hoist-prefix`` (with ``--fast-grads``) through the port: the GAN
step computes the frozen prefix once, in the critic step, and the
generator step runs its rec forward and then the rand suffix on that
prefix (``optim.hoist_index``, ``GeneratorHPVAEGAN.apply_prefix`` /
``apply_suffix``; JAX ``steps.py:173-182, 284-296, 342-352``).

Held, in 2D and 3D as ``tests/test_hoist.py``: the hoisted step against
the JAX package's hoisted step (JAX's draws injected,
``tests/torch_port_fast.py``'s bars); against the port's unhoisted fast
step, the parameters of both models equal and the frozen prefix's
BatchNorm statistics apart (they see the rec forward's update only, the
documented deviation), the suffix's equal; ``GeneratorVAE_nb`` is never
hoisted; the hoist engages only where the plan freezes the encoder,
decoder and a prefix of stages."""
import copy

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.train import optim, steps
from torch_port_runs import one_torch_thread

SCALE = 3
OVER = dict(vae_levels=1, fast_grads=True, hoist_prefix=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _draws(key, pyr, ndim, cfg):
    """JAX's draws of a GAN step keyed ``key`` (one k_fake for both rand
    forwards)."""
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    return dict(noises=fast.noises_of(k_fake, pyr, ndim, SCALE,
                                      lambda i: True),
                eps=fast.eps_of(k_rec, pyr, ndim),
                alpha=float(jax.random.uniform(k_gp, ())))


def _step(G, D, cfg, inputs, draws):
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    optim.freeze_frozen(cfg, G, SCALE)
    return steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D), cfg,
                          *inputs, fast.AMPS, **draws)


@pytest.mark.parametrize("ndim", [2, 3])
def test_hoisted_step_matches_jax_and_the_unhoisted_step(ndim):
    jcfg, jG, gvars = fast.jax_generator(SCALE, ndim, **OVER)
    jD, dvars, port_critic = fast.critics(ndim)
    fns, opt_g_j, opt_d_j, lrs = fast.jax_steps(jcfg, jG, jD, gvars, SCALE,
                                                dvars)
    cfg, G = fast.port_generator(gvars, SCALE, ndim, **OVER)
    assert optim.hoist_index(cfg, G, SCALE) == 2
    pyr = fast.pyramid(cfg, ndim)
    inputs = fast.data(pyr, ndim, SCALE, seed=41)
    key = jax.random.PRNGKey(42)
    gv_new, _, _, _, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        *inputs, jnp.asarray(fast.AMPS), key)
    draws = _draws(key, pyr, ndim, cfg)
    G_u = copy.deepcopy(G)
    metrics = _step(G, port_critic(), cfg, inputs, draws)
    fast.assert_metrics_close(metrics, metrics_ref)
    _, ref = fast.port_generator(fast.np_tree(gv_new), SCALE, ndim, **OVER)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, max(lrs.values()))

    # the unhoisted fast step on the same weights and draws
    cfg_u = copy.copy(cfg)
    cfg_u.hoist_prefix = False
    assert optim.hoist_index(cfg_u, G_u, SCALE) is None
    metrics_u = _step(G_u, port_critic(), cfg_u, inputs, draws)
    for name in metrics:
        assert torch.equal(metrics[name], metrics_u[name]), name
    for (name, p), p_u in zip(G.named_parameters(), G_u.parameters()):
        assert torch.equal(p, p_u), name
    for module, module_u, same in (
            (G.decoder, G_u.decoder, False), (G.body[0], G_u.body[0], False),
            (G.body[1], G_u.body[1], False), (G.body[2], G_u.body[2], True)):
        stats = [torch.equal(a, b) for (n, a), b in zip(
            module.named_buffers(), module_u.buffers()) if "running" in n]
        assert stats and all(stats) == same and (same or not any(stats))


@pytest.mark.parametrize("scale,vae_levels,want", [
    (3, 1, 2), (2, 1, 1), (1, 1, None), (3, 3, 2), (2, 3, None),
    (4, 2, 3)])
def test_hoist_engages_only_when_the_prefix_is_frozen(scale, vae_levels,
                                                     want):
    """GAN scales past the first body stage hoist at the trainable stage;
    a VAE scale (encoder trainable) or a first stage that trains does
    not; and never without --fast-grads."""
    cfg = fast.cfg_of(Config, vae_levels=vae_levels, fast_grads=True,
                      hoist_prefix=True)
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    for _ in range(scale):
        G.init_next_stage(torch.Generator().manual_seed(1))
    assert optim.hoist_index(cfg, G, scale) == want
    cfg.fast_grads = False
    assert optim.hoist_index(cfg, G, scale) is None


def test_vae_nb_is_not_hoisted():
    """As in the JAX package (no apply_prefix on its GeneratorVAE_nb): the
    flags leave its GAN step the plain fast step, bit for bit."""
    cfg = fast.cfg_of(Config, generator="GeneratorVAE_nb", **OVER)
    G = make_generator("GeneratorVAE_nb", cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    assert not G.split_forwards and optim.hoist_index(cfg, G, SCALE) is None
    with pytest.raises(NotImplementedError):
        G.apply_prefix(fast.AMPS, upto=1)
    _, _, port_critic = fast.critics(3)
    inputs = fast.data(cfg.pyramid(), 3, SCALE, seed=43)
    runs = []
    for hoist in (True, False):
        c = copy.copy(cfg)
        c.hoist_prefix = hoist
        g = copy.deepcopy(G)
        runs.append((_step(g, port_critic(), c, inputs,
                           {"generator": torch.Generator().manual_seed(5)}),
                     g))
    (m_h, g_h), (m_u, g_u) = runs
    for name in m_h:
        assert torch.equal(m_h[name], m_u[name]), name
    for a, b in zip(g_h.state_dict().values(), g_u.state_dict().values()):
        assert torch.equal(a, b)
