"""``--remat``, ``--remat-blocks`` and ``--gp-chunked`` through the port
(``models/remat.py``, ``losses.calc_gradient_penalty(chunked=...)``;
JAX ``generators.py:47-90``, ``steps.py:43-80``, ``losses/__init__.py:
43-82``), the counterpart of tests/test_remat.py on seeded port models
handed to the JAX package as flax trees (``torch_port_flax``):

* the generator's gradients (a rec forward) and the critic's with the
  WGAN-GP's double backward, at each level: bit-equal to the unwrapped
  port (the recompute repeats the same operations), and equal to the
  JAX package's remat'd gradients at the f32 bar (``rtol=2e-3,
  atol=2e-4``);
* the chunked penalty (True and ``"unroll"``) against the batched one
  and against the JAX package's chunked one; the BatchNorm baselines
  critic keeps the batched penalty;
* after a remat'd GAN step (and a baselines step with the BatchNorm
  critic) every weight, BatchNorm running statistic and spectral vector
  equals the plain step's bit for bit: a recompute moves nothing twice;
* remat composes with ``--fast-grads``, ``--hoist-prefix`` and
  ``--fused-forwards``: the same weights as without it;
* the kernels' calls on the CPU (each a launch on the card) follow
  ``chip_smoke.gan_step_launches``, the structure-derived counts phase
  15 holds the card's launches to."""
import collections
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu.losses import calc_gradient_penalty as j_gp
from hpvaegan_tpu.train.optim import gparams_view, merge_gparams
from hpvaegan_tpu.train.steps import apply_disc
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.losses import calc_gradient_penalty
from hpvaegan_tpu_torch.models.generators import to_model_layout
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
from torch_port_runs import one_torch_thread

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the structure-derived launch counts)

SCALE = 3
LEVELS = {True: dict(remat=True), "blocks": dict(remat_blocks=True)}
LAMBDA = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _data(seed=4):
    rng = np.random.default_rng(seed)
    cfg = fast.cfg_of(Config)
    pyr = cfg.pyramid()
    real = np.tanh(rng.standard_normal(
        (fast.BATCH, *pyr.shape3d(SCALE), 3))).astype(np.float32)
    fake = np.tanh(rng.standard_normal(real.shape)).astype(np.float32)
    real_zero = np.tanh(rng.standard_normal(
        (fast.BATCH, *pyr.shape3d(0), 3))).astype(np.float32)
    return pyr, real, fake, real_zero


def _grads(module):
    return {n: (p.grad.clone() if p.grad is not None
                else torch.zeros_like(p))
            for n, p in module.named_parameters()}


def _port_g_grads(gvars, eps, real, real_zero, **over):
    cfg, G = fast.port_generator(gvars, SCALE, **over)
    out, vae_out, (mu, _) = G.apply(fast.AMPS, real_zero=real_zero,
                                    mode="rec", train=True, eps=eps,
                                    update_stats=True)
    loss = ((out - torch.as_tensor(real)).square().mean()
            + vae_out.square().mean() + mu.square().mean())
    loss.backward()
    return float(loss.detach()), _grads(G), G


def _same(a: dict, b: dict):
    for name, t in a.items():
        assert torch.equal(t, b[name]), name


def _close(got: dict, want: dict):
    for name, t in got.items():
        fast.close(t.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("level", [True, "blocks"])
def test_generator_grads_match_the_plain_port_and_jax(level):
    pyr, real, _, real_zero = _data()
    key = jax.random.PRNGKey(9)
    eps = fast.eps_of(key, pyr, 3)
    jcfg, jG, gvars = fast.jax_generator(SCALE, **LEVELS[level])
    v0, g0, _ = _port_g_grads(gvars, eps, real, real_zero)
    v1, g1, G = _port_g_grads(gvars, eps, real, real_zero, **LEVELS[level])
    assert v0 == v1
    _same(g1, g0)

    amps = jnp.asarray(fast.AMPS, jnp.float32)

    def loss(pview):
        gv = merge_gparams(gvars, pview)
        (out, vae_out, (mu, _)), _ = jG.apply(gv, amps, key,
                                              real_zero=real_zero,
                                              mode="rec", train=True)
        return (jnp.mean((out - real) ** 2) + jnp.mean(vae_out ** 2)
                + jnp.mean(mu ** 2))

    jv, jgrads = jax.value_and_grad(loss)(gparams_view(gvars))
    fast.close(v1, float(jv), "loss")
    _close(g1, convert.generator_moments(G, gvars, fast.np_tree(jgrads)))


def _critic_loss(D, real, fake, alpha, level, chunked=False):
    """``-mean(D(real)) + GP`` backpropagated into ``D``; returns the
    loss and the penalty."""
    D.zero_grad(set_to_none=True)
    x_real, x_fake = to_model_layout(real), to_model_layout(fake)
    out = D(x_real, remat=level)
    gp = calc_gradient_penalty(
        lambda x: D(x, use_kernels=False, remat=level), x_real, x_fake,
        LAMBDA, alpha, chunked=chunked)
    loss = -out.mean() + gp
    loss.backward()
    return float(loss), float(gp)


def _jax_critic(jD, dvars, real, fake, key, level, chunked=False):
    def loss(params):
        dv = {**dvars, "params": params}
        out, _ = apply_disc(jD, dv, real, train=True, remat=level)
        gp = j_gp(lambda x: apply_disc(jD, dv, x, train=True,
                                       remat=level)[0],
                  real, fake, LAMBDA, key, chunked=chunked)
        return -jnp.mean(out) + gp
    val, grads = jax.value_and_grad(loss)(dvars["params"])
    return float(val), fast.np_tree(grads)


@pytest.mark.parametrize("level", [True, "blocks"])
def test_critic_gp_grads_match_the_plain_port_and_jax(level):
    _, real, fake, _ = _data()
    jD, dvars, port_critic = fast.critics(3)
    key = jax.random.PRNGKey(10)
    alpha = float(jax.random.uniform(key, ()))
    D0, D1 = port_critic(), port_critic()
    v0, _ = _critic_loss(D0, real, fake, alpha, False)
    v1, _ = _critic_loss(D1, real, fake, alpha, level)
    assert v0 == v1
    _same(_grads(D1), _grads(D0))
    jv, jgrads = _jax_critic(jD, dvars, real, fake, key, level)
    fast.close(v1, jv, "loss")
    _close(_grads(D1), convert.critic_moments(D1, dvars, jgrads))


@pytest.mark.parametrize("case", ["chunked", "unroll", "bn_critic"])
def test_chunked_gp_matches_the_batched_one(case):
    """True and "unroll" run the per-sample loop (the same in the port)
    and equal the batched penalty and the JAX package's chunked one; the
    BatchNorm baselines critic takes the batched penalty whatever
    ``--gp-chunked`` says (its statistics couple the samples)."""
    _, real, fake, _ = _data()
    if case == "bn_critic":
        cfg = fast.cfg_of(Config, gp_chunked=True)
        D = make_discriminator("WDiscriminatorBaselines", cfg, 3)
        D.reset_parameters(torch.Generator().manual_seed(3))
        chunked = steps._gp_chunked(cfg, D)
        assert chunked is False
        assert steps._gp_chunked(cfg, make_discriminator(
            "WDiscriminator3D", cfg, 3)) is True
        D0 = copy.deepcopy(D)
        assert _critic_loss(D, real, fake, 0.3, False, chunked) == \
            _critic_loss(D0, real, fake, 0.3, False)
        _same(_grads(D), _grads(D0))
        return
    mode = True if case == "chunked" else "unroll"
    jD, dvars, port_critic = fast.critics(3)
    key = jax.random.PRNGKey(11)
    alpha = float(jax.random.uniform(key, ()))
    D0, D1 = port_critic(), port_critic()
    v0, gp0 = _critic_loss(D0, real, fake, alpha, False)
    v1, gp1 = _critic_loss(D1, real, fake, alpha, False, chunked=mode)
    fast.close(gp1, gp0, "gp")
    fast.close(v1, v0, "loss")
    _close(_grads(D1), _grads(D0))
    jv, jgrads = _jax_critic(jD, dvars, real, fake, key, False, mode)
    fast.close(v1, jv, "loss vs jax")
    _close(_grads(D1), convert.critic_moments(D1, dvars, jgrads))


def _hpvaegan_step(**over):
    """One GAN step of a seeded tiny model from fixed draws; returns the
    generator and the critic after it."""
    cfg = fast.cfg_of(Config, **over)
    cfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    real, real_zero, noise_init = fast.data(pyr, 3, SCALE, 5)
    if cfg.fast_grads:
        optim.freeze_frozen(cfg, G, SCALE)
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    steps.gan_step(G, D, opt_g, opt_d, cfg, real, real_zero, noise_init,
                   fast.AMPS, generator=torch.Generator().manual_seed(2))
    return (G, D), (opt_g, opt_d)


def _baseline_step(**over):
    cfg = fast.cfg_of(Config, generator="GeneratorCSG",
                      discriminator="WDiscriminatorBaselines", **over)
    cfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    G = make_generator("GeneratorCSG", cfg, pyr, ndim=3)
    G.init(torch.Generator().manual_seed(0))
    for _ in range(SCALE):
        G.init_next_stage()
    G.requires_grad_(True)
    D = make_discriminator("WDiscriminatorBaselines", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    real = np.tanh(rng.standard_normal(
        (fast.BATCH, *pyr.shape3d(SCALE), 3))).astype(np.float32)
    z_shape = (fast.BATCH, *pyr.shape3d(0), 3)
    noise_init = rng.standard_normal(z_shape).astype(np.float32)
    z_init = rng.standard_normal(z_shape).astype(np.float32)
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    steps.baseline_step(G, D, opt_g, opt_d, cfg, real, noise_init, z_init,
                        fast.AMPS, generator=torch.Generator().manual_seed(2))
    return (G, D), (opt_g, opt_d)


def _states_equal(a, b):
    for m, n in zip(a, b):
        want = n.state_dict()
        for name, t in m.state_dict().items():
            assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("model,level", [
    ("hpvaegan", True), ("hpvaegan", "blocks"), ("baselines", True),
    ("baselines", "blocks")])
def test_a_remat_step_moves_statistics_once(model, level):
    """Weights, BatchNorm running statistics (the generator's, and the
    baselines critic's moved by its real and fake forwards) and the
    spectral u/v after a remat'd step equal the plain step's bit for
    bit."""
    step = _hpvaegan_step if model == "hpvaegan" else _baseline_step
    plain, _ = step()
    remat, _ = step(**LEVELS[level])
    _states_equal(remat, plain)
    moved = [n for n, b in plain[0].named_buffers() if "running" in n]
    assert moved


@pytest.mark.parametrize("flags", [
    dict(fast_grads=True), dict(fast_grads=True, hoist_prefix=True),
    dict(fast_grads=True, fused_forwards=True)])
@pytest.mark.parametrize("level", [True, "blocks"])
def test_remat_composes_with_the_fast_path(flags, level):
    plain, (opt_g, _) = _hpvaegan_step(**flags)
    remat, (opt_g_r, _) = _hpvaegan_step(**flags, **LEVELS[level])
    _states_equal(remat, plain)
    for a, b in zip(opt_g.param_groups, opt_g_r.param_groups):
        for p, q in zip(a["params"], b["params"]):
            assert torch.equal(opt_g.state[p]["exp_avg"],
                               opt_g_r.state[q]["exp_avg"])


@pytest.fixture
def kernel_calls(monkeypatch):
    """Every call the K1/K2 wrappers make on the CPU, by the kind of
    kernel it would launch on the card."""
    calls = collections.Counter()
    forward, dw, pair = cp._forward, cp.conv3d64_dw, cf.conv3d64_pair_forward

    def counted_forward(x, w, b, neg_slope, kind):
        calls[kind] += 1
        return forward(x, w, b, neg_slope, kind)

    def counted_dw(x, dy):
        calls["dw"] += 1
        return dw(x, dy)

    def counted_pair(*args, **kwargs):
        calls["pair"] += 1
        return pair(*args, **kwargs)

    monkeypatch.setattr(cp, "_forward", counted_forward)
    monkeypatch.setattr(cp, "conv3d64_dw", counted_dw)
    monkeypatch.setattr(cf, "conv3d64_pair_forward", counted_pair)
    return calls


@pytest.mark.parametrize("mode,level", [
    ("plain", False), ("plain", True), ("plain", "blocks"),
    ("hoist", True), ("fused", "blocks")])
def test_kernel_calls_follow_the_derived_launches(kernel_calls, mode,
                                                  level):
    """At nfc 64 under ``--pconv --pconv-all --pfuse`` (4 stages, 3
    layers: one K2 pair and one K1 block in the critic), the calls a
    GAN step makes equal ``chip_smoke.gan_step_launches``'s counts, the
    recomputed forwards and the gp-chunked rung included."""
    stages, layers, vae_levels = 4, 3, 2
    flags = {"plain": {}, "hoist": dict(fast_grads=True, hoist_prefix=True),
             "fused": dict(fast_grads=True, fused_forwards=True)}[mode]
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=layers, enc_blocks=1, vae_levels=vae_levels,
                 pconv=True, pconv_all=True, pfuse=True,
                 gp_chunked=bool(level), **flags,
                 **(LEVELS[level] if level else {}))
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = stages
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(stages):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    real, real_zero, noise_init = fast.data(pyr, 3, stages, 7)
    if cfg.fast_grads:
        optim.freeze_frozen(cfg, G, stages)
    opt_g = optim.build_g_optimizer(cfg, G, stages)
    steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D), cfg, real,
                   real_zero, noise_init, [1.0] + [0.1] * stages,
                   generator=torch.Generator().manual_seed(2))
    want = chip_smoke.gan_step_launches(
        mode, stages=stages, num_layer=layers, vae_levels=vae_levels,
        train_depth=cfg.train_depth, remat=level, gp_chunked=cfg.gp_chunked)
    assert dict(kernel_calls) == {
        "fwd": want["conv3d64_fwd"], "pair": want["conv3d64_pair"],
        "dx": want["conv3d64_dx"], "dw": want["conv3d64_dw"]}
