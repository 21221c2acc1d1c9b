"""The WGAN-GP's critic route in the training steps
(``train/steps._penalty_critic``): an SN critic whose body convs take K1
and that has no mesh runs the penalty's body on K1 and none on K2; every
other critic runs it on stock convs.

Held on the CPU, where each K1 or K2 call is the kernel's plain version
(a launch on the card), on the tiny nfc-64 model under ``--pconv
--pconv-all --pfuse`` (one K2 pair in the critic):

* one ``gan_step`` in each mode (plain, ``--remat``, ``--remat-blocks``,
  ``--gp-chunked``, ``--fast-grads --hoist-prefix``,
  ``--fused-forwards``): its K1 calls are
  those of the same step with the penalty on stock convs plus those of
  the penalty alone, and ``chip_smoke.gan_step_launches``'s; K2's
  forwards and backwards are the stock-route
  step's (the critic step's and the generator step's: the penalty
  reaches no K2); the metrics and every parameter after Adam lie within
  the f32 bars of the JAX step (``tests/torch_port_fast.py``'s), and of
  the stock-route step;
* ``baseline_step`` with the SN critic takes the same route; with the
  BatchNorm critic, and a 2D ``gan_step``, make no K1 call;
* ``steps._critic(D, cfg, level)(x, use_kernels=False)`` stays on stock
  convs: no K1 or K2 call, forward or double backward;
* the route follows the critic alone: K1 for a 3D 64-channel ``pconv``
  critic, stock without ``pconv``, in 2D, under a mesh and for the
  BatchNorm critic."""
import collections
import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.losses import calc_gradient_penalty
from hpvaegan_tpu_torch.models.generators import to_model_layout
from hpvaegan_tpu_torch.models.networks import (WDiscriminator,
                                                WDiscriminatorBaselines)
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.models.remat import remat_level
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
from torch_port_runs import one_torch_thread

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the structure-derived launch counts)

SCALE = 3
K1_MODEL = dict(nfc=64, pconv_all=True, pfuse=True)
MODES = {"plain": {}, "remat": dict(remat=True),
         "remat_blocks": dict(remat_blocks=True),
         "gp_chunked": dict(gp_chunked=True),
         "hoist": dict(vae_levels=1, fast_grads=True, hoist_prefix=True),
         "fused": dict(fast_grads=True, fused_forwards=True)}
# chip_smoke.gan_step_launches's mode and remat level of each
DERIVED = {"plain": ("plain", False), "remat": ("plain", True),
           "remat_blocks": ("plain", "blocks"), "gp_chunked": ("plain", False),
           "hoist": ("hoist", False), "fused": ("fused", False)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture
def calls(monkeypatch):
    """Every call of the K1 and K2 wrappers, by the kernel it would
    launch on the card (K2's backward as ``pair_bwd``)."""
    seen = collections.Counter()
    forward, dw = cp._forward, cp.conv3d64_dw
    pair, pair_bwd = cf.conv3d64_pair_forward, cf.conv3d64_pair_backward

    def counted(name, fn, key=None):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            seen[key(*args) if key else name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(cp, "_forward", counted(
        None, forward, lambda x, w, b, neg_slope, kind: kind))
    monkeypatch.setattr(cp, "conv3d64_dw", counted("dw", dw))
    monkeypatch.setattr(cf, "conv3d64_pair_forward", counted("pair", pair))
    monkeypatch.setattr(cf, "conv3d64_pair_backward",
                        counted("pair_bwd", pair_bwd))
    return seen


def _take(seen) -> dict:
    out = {k: seen[k] for k in ("fwd", "dx", "dw", "pair", "pair_bwd")}
    seen.clear()
    return out


def _k1_critic(dvars):
    D = WDiscriminator(3, 64, 3, fast.TINY["num_layer"], ndim=3, pconv=True,
                       pfuse=True)
    convert.load_discriminator(D, dvars)
    return D


def _stock(D, forward):
    """The penalty's critic on stock convs: the JAX package's route."""
    return lambda x: forward(x, use_kernels=False)


def _draws(key, cfg, pyr):
    """JAX's draws of a GAN step keyed ``key`` (the fused forwards take
    their ``eps`` from the one ``k_fake`` too)."""
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    return dict(noises=fast.noises_of(k_fake, pyr, 3, SCALE,
                                      lambda i: cfg.vae_levels <= i + 1),
                eps=fast.eps_of(k_fake if cfg.fused_forwards else k_rec,
                                pyr, 3),
                alpha=float(jax.random.uniform(k_gp, ())))


def _gan_step(cfg, G, D, inputs, draws):
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    if cfg.fast_grads:
        optim.freeze_frozen(cfg, G, SCALE)
    return steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D), cfg,
                          *inputs, fast.AMPS, **draws)


def _penalty_alone(cfg, D, inputs, draws) -> None:
    """The step's penalty and its backward, on its own."""
    real, _, _ = inputs
    x = to_model_layout(real)
    with torch.no_grad():
        fake = torch.tanh(x * 0.5 + 0.1)
    critic = steps._critic(D, cfg, remat_level(cfg))
    D.zero_grad(set_to_none=True)
    gp = calc_gradient_penalty(steps._penalty_critic(D, critic), x, fake,
                               cfg.lambda_grad, draws["alpha"],
                               chunked=steps._gp_chunked(cfg, D))
    if gp.requires_grad:
        gp.backward()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gan_step_penalty_runs_on_k1(calls, monkeypatch, mode):
    over = {**K1_MODEL, **MODES[mode]}
    jcfg, jG, gvars = fast.jax_generator(SCALE, **over)
    jD, dvars, _ = fast.critics(3, nfc=64)
    fns, opt_g_j, opt_d_j, lrs = fast.jax_steps(jcfg, jG, jD, gvars, SCALE,
                                                dvars)
    cfg, G = fast.port_generator(gvars, SCALE, **over)
    pyr = cfg.pyramid()
    inputs = fast.data(pyr, 3, SCALE, seed=61)
    key = jax.random.PRNGKey(62)
    gv_new, dv_new, _, _, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        *inputs, jnp.asarray(fast.AMPS), key)
    draws = _draws(key, cfg, pyr)
    G_s = copy.deepcopy(G)

    calls.clear()
    D = _k1_critic(dvars)
    metrics = _gan_step(cfg, G, D, inputs, draws)
    k1_route = _take(calls)
    _penalty_alone(cfg, _k1_critic(dvars), inputs, draws)
    penalty = _take(calls)
    with monkeypatch.context() as m:
        m.setattr(steps, "_penalty_critic", _stock)
        D_s = _k1_critic(dvars)
        metrics_s = _gan_step(cfg, G_s, D_s, inputs, draws)
    stock_route = _take(calls)

    # the penalty's calls: K1 alone, each body conv inner fwd and dx,
    # outer dx and dw (more forwards where remat recomputes them)
    layers = fast.TINY["num_layer"]
    assert penalty["pair"] == penalty["pair_bwd"] == 0
    assert penalty["dx"] == 2 * penalty["dw"] > 0
    assert penalty["fwd"] >= penalty["dw"] and penalty["dw"] % layers == 0
    assert stock_route["pair"] == k1_route["pair"] >= 2
    assert stock_route["pair_bwd"] == k1_route["pair_bwd"] == 2
    for kind in ("fwd", "dx", "dw"):
        assert k1_route[kind] == stock_route[kind] + penalty[kind], kind
    derived, level = DERIVED[mode]
    want = chip_smoke.gan_step_launches(
        derived, stages=SCALE, num_layer=layers, vae_levels=cfg.vae_levels,
        train_depth=cfg.train_depth, remat=level or remat_level(cfg),
        gp_chunked=cfg.gp_chunked)
    assert {k: k1_route[k] for k in ("fwd", "pair", "dx", "dw")} == {
        "fwd": want["conv3d64_fwd"], "pair": want["conv3d64_pair"],
        "dx": want["conv3d64_dx"], "dw": want["conv3d64_dw"]}

    fast.assert_metrics_close(metrics, metrics_ref)
    fast.assert_metrics_close(metrics, metrics_s)
    _, G_ref = fast.port_generator(fast.np_tree(gv_new), SCALE, **over)
    fast.assert_buffers_close(G, G_ref)
    fast.assert_params_after_adam(G, G_ref, max(lrs.values()))
    fast.assert_params_after_adam(G, G_s, max(lrs.values()))
    D_ref = _k1_critic(fast.np_tree(dv_new))
    fast.assert_buffers_close(D, D_ref)
    fast.assert_params_after_adam(D, D_ref, cfg.lr_d)
    fast.assert_params_after_adam(D, D_s, cfg.lr_d)


def _baseline_models(discriminator, ndim=3):
    cfg = fast.cfg_of(Config, generator="GeneratorCSG",
                      discriminator=discriminator, **K1_MODEL)
    cfg.scale_idx = SCALE
    pyr = fast.pyramid(cfg, ndim)
    G = make_generator("GeneratorCSG", cfg, pyr, ndim=ndim)
    G.init(torch.Generator().manual_seed(0))
    for _ in range(SCALE):
        G.init_next_stage()
    G.requires_grad_(True)
    D = make_discriminator(discriminator, cfg, ndim)
    D.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    real = np.tanh(rng.standard_normal(
        (fast.BATCH, *fast.shape(pyr, ndim, SCALE), 3))).astype(np.float32)
    z_shape = (fast.BATCH, *fast.shape(pyr, ndim, 0), 3)
    noise_init = rng.standard_normal(z_shape).astype(np.float32)
    z_init = rng.standard_normal(z_shape).astype(np.float32)
    return cfg, G, D, (real, noise_init, z_init)


def _baseline_step(cfg, G, D, inputs):
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    return steps.baseline_step(G, D, opt_g, opt_d, cfg, *inputs, fast.AMPS,
                               alphas=[0.41],
                               generator=torch.Generator().manual_seed(2))


def test_baseline_step_with_the_sn_critic_runs_its_penalty_on_k1(
        calls, monkeypatch):
    cfg, G, D, inputs = _baseline_models("WDiscriminator3D")
    G_s, D_s = copy.deepcopy(G), copy.deepcopy(D)
    calls.clear()
    metrics = _baseline_step(cfg, G, D, inputs)
    k1_route = _take(calls)
    with monkeypatch.context() as m:
        m.setattr(steps, "_penalty_critic", _stock)
        metrics_s = _baseline_step(cfg, G_s, D_s, inputs)
    stock_route = _take(calls)
    layers = fast.TINY["num_layer"]
    # the critic's two forwards and the frozen one: a K2 pair each, its
    # backward in all three (two K1-dx each, two K1-dw in the critic
    # step's); the penalty: K1 on both body convs
    assert stock_route == {"fwd": 0, "dx": 6, "dw": 4, "pair": 3,
                           "pair_bwd": 3}
    assert k1_route == {"fwd": layers, "dx": 6 + 2 * layers,
                        "dw": 4 + layers, "pair": 3, "pair_bwd": 3}
    fast.assert_metrics_close(metrics, metrics_s)
    fast.assert_params_after_adam(D, D_s, cfg.lr_d)
    fast.assert_params_after_adam(G, G_s, cfg.lr_g)


@pytest.mark.parametrize("case", ["bn_baselines", "2d"])
def test_steps_without_a_k1_critic_make_no_k1_call(calls, case):
    if case == "bn_baselines":
        cfg, G, D, inputs = _baseline_models("WDiscriminatorBaselines")
        metrics = _baseline_step(cfg, G, D, inputs)
    else:
        over = dict(K1_MODEL)
        jcfg, _, gvars = fast.jax_generator(SCALE, 2, **over)
        cfg, G = fast.port_generator(gvars, SCALE, 2, **over)
        D = make_discriminator("WDiscriminator2D", cfg, 2)
        D.reset_parameters(torch.Generator().manual_seed(1))
        inputs = fast.data(fast.pyramid(cfg, 2), 2, SCALE, seed=63)
        metrics = _gan_step(cfg, G, D, inputs,
                            {"generator": torch.Generator().manual_seed(3)})
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert sum(calls.values()) == 0, dict(calls)


def test_the_critic_without_kernels_stays_on_stock_convs(calls):
    """``use_kernels=False`` on ``steps._critic``'s forward (what the
    benchmark's ``gp_ms`` reader times) reaches neither K1 nor K2, in the
    penalty's forward and double backward."""
    cfg = fast.cfg_of(Config, **K1_MODEL)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(5))
    assert D.pfuse and all(b.kernel_route for b in D.body)
    _, real, _ = fast.data(cfg.pyramid(), 3, 1, seed=64)
    x = to_model_layout(real)
    critic = steps._critic(D, cfg, False)
    gp = calc_gradient_penalty(lambda z: critic(z, use_kernels=False), x,
                               torch.tanh(x + 0.2), 0.1, 0.3)
    gp.backward()
    assert D.body[0].weight.grad is not None
    assert sum(calls.values()) == 0, dict(calls)


@pytest.mark.parametrize("critic,want", [
    ("k1", {"fuse": False}), ("k1_unfused", {"fuse": False}),
    ("no_pconv", {"use_kernels": False}), ("2d", {"use_kernels": False}),
    ("mesh", {"use_kernels": False}), ("nfc8", {"use_kernels": False}),
    ("bn_baselines", {"use_kernels": False})])
def test_the_penalty_route_follows_the_critic(critic, want):
    if critic == "bn_baselines":
        D = WDiscriminatorBaselines(3, 64, 3, 1, 2, ndim=3)
    else:
        D = WDiscriminator(3, 8 if critic == "nfc8" else 64, 3, 2,
                           ndim=2 if critic == "2d" else 3,
                           pconv=critic != "no_pconv",
                           pfuse=critic != "k1_unfused")
    if critic == "mesh":
        D.mesh = object()
    seen = []
    steps._penalty_critic(D, lambda x, **route: seen.append(route))(None)
    assert seen == [want]
