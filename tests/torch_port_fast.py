"""What the fast-path parity tests share (``test_torch_port_fast_grads.py``,
``test_torch_port_hoist.py``, ``test_torch_port_fused_forwards.py``): a
tiny model grown from a seeded port model and handed to the JAX package
as flax trees (``torch_port_flax``), the JAX steps built with the fast
flags, JAX's draws in the port's form, and the parity bars.

Tolerances: metrics and BatchNorm statistics at the f32 bar ``rtol=2e-3,
atol=2e-4``; parameters after one Adam step within ``2 * lr`` with at
most 0.5% of the elements past the f32 bar (Adam's first update is about
``lr * sign(g)``, ``tests/test_torch_port_train_step.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_hpvaegan_steps
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.utils import convert
import torch_port_flax as flax_vars

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=8, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2)
BATCH = 2
AMPS = [1.0, 0.3, 0.2, 0.15]


def cfg_of(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


def pyramid(cfg, ndim):
    return cfg.pyramid() if ndim == 3 else cfg.pyramid2d()


def shape(pyr, ndim, scale):
    return pyr.shape3d(scale) if ndim == 3 else pyr.shape2d(scale)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def copy_tree(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def port_generator(gvars, scale, ndim=3, name="GeneratorHPVAEGAN", **over):
    cfg = cfg_of(Config, **over)
    cfg.scale_idx = scale
    G = make_generator(name, cfg, pyramid(cfg, ndim), ndim=ndim)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    G.requires_grad_(True)
    return cfg, G


def jax_generator(scale, ndim=3, **over):
    """The JAX config and generator, and the variables of a seeded port
    model grown to ``scale`` stages, as flax trees."""
    jcfg = cfg_of(JConfig, **over)
    jcfg.scale_idx = scale
    jG = JGenerator(jcfg, pyramid(jcfg, ndim), ndim=ndim)
    cfg = cfg_of(Config, **over)
    G = make_generator("GeneratorHPVAEGAN", cfg, pyramid(cfg, ndim),
                       ndim=ndim)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    return jcfg, jG, flax_vars.generator(G)


def critics(ndim, nfc=8, seed=13):
    """(JAX critic, its dvars, a function making the port's critic on those
    variables)."""
    num_layer = TINY["num_layer"]
    jD = JCritic(nfc=nfc, ker_size=3, num_layer=num_layer, ndim=ndim)
    D0 = WDiscriminator(3, nfc, 3, num_layer, ndim=ndim)
    D0.reset_parameters(torch.Generator().manual_seed(seed))
    dvars = flax_vars.critic(D0)

    def port(dv=dvars):
        D = WDiscriminator(3, nfc, 3, num_layer, ndim=ndim)
        convert.load_discriminator(D, dv)
        return D
    return jD, dvars, port


def jax_steps(jcfg, jG, jD, gvars, scale, dvars=None):
    pview = joptim.gparams_view(gvars)
    ml, bl, lrs = joptim.hpvaegan_group_plan(jcfg, scale, len(gvars["body"]))
    tx_g, opt_g = joptim.build_g_optimizer(jcfg, pview, ml, bl, lrs,
                                           jcfg.grad_clip)
    tx_d = opt_d = None
    if dvars is not None:
        tx_d, opt_d = joptim.build_d_optimizer(jcfg, dvars["params"])
    fns = make_hpvaegan_steps(jG, jD, jcfg, tx_g, tx_d, group_plan=(ml, bl))
    return fns, opt_g, opt_d, lrs


def data(pyr, ndim, scale, seed, latent=TINY["latent_dim"]):
    """(real, real_zero, noise_init) of the tiny pyramid, from ``seed``."""
    rng = np.random.default_rng(seed)
    real = np.tanh(rng.standard_normal((BATCH, *shape(pyr, ndim, scale), 3)))
    real_zero = np.tanh(rng.standard_normal((BATCH, *shape(pyr, ndim, 0),
                                             3)))
    noise_init = rng.standard_normal((BATCH, *shape(pyr, ndim, 0), latent))
    return (real.astype(np.float32), real_zero.astype(np.float32),
            noise_init.astype(np.float32))


def eps_of(key, pyr, ndim, latent=TINY["latent_dim"]):
    """The reparameterization draw of a rec forward keyed ``key``
    (generators.py:174)."""
    _, k_rep = jax.random.split(key)
    return np.asarray(jax.random.normal(
        k_rep, (BATCH, *shape(pyr, ndim, 0), latent)))


def noises_of(key, pyr, ndim, n_stages, noisy):
    """The stage noises of a rand forward keyed ``key`` (generators.py:174,
    255-256; the fused forward's rand half, :294-297); ``noisy(idx)``:
    does stage ``idx`` take noise."""
    key, _ = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        if noisy(idx):
            key, k_n = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(
                k_n, (BATCH, *shape(pyr, ndim, idx + 1), 3))))
        else:
            noises.append(None)
    return noises


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def assert_metrics_close(got, ref):
    for name, value in ref.items():
        close(float(got[name]), float(value), name)


def assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        close(buf.numpy(), want[name].numpy(), name)


def assert_params_after_adam(module, ref, lr_max):
    want = dict(ref.named_parameters())
    off = total = 0
    for name, p in module.named_parameters():
        got, exp = p.detach().numpy(), want[name].detach().numpy()
        diff = np.abs(got - exp)
        assert diff.max() <= 2 * lr_max * 1.01 + ATOL, (name, diff.max())
        off += int(np.sum(diff > ATOL + RTOL * np.abs(exp)))
        total += diff.size
    assert off <= 0.005 * total, (off, total)


def jax_first_moments(opt_state, template):
    """Adam's first moments of a JAX generator state after one step, merged
    over the label groups into one params view (zeros where no group
    holds a leaf): ``(1 - b1)`` times the clipped gradient."""
    mus = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    leaves, treedef = jax.tree_util.tree_flatten(template)
    merged = [np.zeros_like(np.asarray(a)) for a in leaves]
    for mu in mus:
        flat = jax.tree_util.tree_flatten(
            mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for i, leaf in enumerate(flat):
            if not isinstance(leaf, optax.MaskedNode):
                merged[i] = np.asarray(leaf)
    return jax.tree_util.tree_unflatten(treedef, merged)


def assert_first_moments_match(G, opt_g, gvars, opt_state_jax, scale,
                               ndim=3, **over):
    """The port's Adam first moments (every trainable parameter's) equal
    the JAX step's at the f32 bar: the clipped gradients agree."""
    template = joptim.gparams_view(gvars)
    mu = jax_first_moments(opt_state_jax, template)
    _, ref = port_generator(joptim.merge_gparams(gvars, mu), scale, ndim,
                            **over)
    want = dict(ref.named_parameters())
    names = {id(p): n for n, p in G.named_parameters()}
    n = 0
    for group in opt_g.param_groups:
        for p in group["params"]:
            close(opt_g.state[p]["exp_avg"].numpy(),
                  want[names[id(p)]].detach().numpy(), names[id(p)])
            n += 1
    assert n > 0
