"""The SinGAN / ConSinGAN baselines through the port against the JAX
package on the CPU, on the same weights (``utils/convert.py``; the trees
come from seeded port models, ``torch_port_flax``) and with JAX's draws
injected: the N(0, 0.02) init, ``WDiscriminatorBaselines``, ``CSGStage``,
``SGStage``, ``GeneratorCSG`` and ``GeneratorSG`` in rand and rec mode,
``baselines_group_plan``, and the baseline step against
``make_baseline_steps`` at Dsteps/Gsteps 1 and 2 and alpha 10 and 0, on
either critic.

The forwards are held against the JAX package evaluated exactly
(``exact_reference``: float64, its BatchNorm statistics in float64 and
two-pass).  Its own f32 run computes the BatchNorm variance as
``E[x^2] - E[x]^2`` in f32 (flax's fast variance), which loses about
three digits where zero padding dominates a batch: the baselines pad
every stage's input (``num_layer + 2`` a side for SinGAN, 4 at these
shapes, so most of a rec-mode stage input is zeros and the head conv's
output there its bias), and the critic pads its input the same way.
There the f32 reference is off the exact one by up to 1.8e-3 while the
port's f32 result stays within 2e-5 of it (and the exact reference
agrees with the port in float64 to 1e-7).  The steps are held against
the f32 reference, as the other step tests are.

Tolerances: f32 ``rtol=2e-3, atol=2e-4``; parameters after a step within
``Gsteps * 2 * lr`` of JAX's (each Adam update is about ``lr * sign(g)``,
and a gradient near zero may take the other sign), at most 0.5% of the
elements beyond the f32 bar, as ``tests/test_torch_port_train_step.py``."""
import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models import blocks as jblocks
from hpvaegan_tpu.models import generators as jgen
from hpvaegan_tpu.models import networks as jnet
from hpvaegan_tpu.models.registry import make_discriminator as jmake_d
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_baseline_steps
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models import blocks, networks
from hpvaegan_tpu_torch.models.generators import (to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
import torch_port_flax as flax_vars
from torch_port_runs import one_torch_thread

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=8, num_layer=2,
            batch_size=2, generator="GeneratorCSG")
BATCH, SCALE = 2, 2
AMPS = [1.0, 0.3, 0.2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


@contextlib.contextmanager
def exact_reference():
    """The JAX package in float64, with the BatchNorm statistics its
    ``ConvBlock`` asks in f32 taken in float64 and two-pass (see the
    module docstring).  Jit inside the block; hand it float64 arrays."""
    flax_nn = jblocks.nn
    patched = types.SimpleNamespace(**{k: getattr(flax_nn, k)
                                       for k in dir(flax_nn)
                                       if not k.startswith("__")})
    patched.BatchNorm = lambda **kw: flax_nn.BatchNorm(
        **{**kw, "dtype": jnp.float64, "use_fast_variance": False})
    jblocks.nn = patched
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jblocks.nn = flax_nn


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _x(shape, seed):
    return np.tanh(np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def _models(name, n_stages=SCALE + 1, **over):
    """(JAX config, JAX generator, its variables, port config, port
    generator loaded from them): a seeded port model grown to
    ``n_stages``, through the flax trees and the converter."""
    jcfg = _cfg(JConfig, generator=name, **over)
    jG = getattr(jgen, name)(jcfg, jcfg.pyramid(), 3)
    cfg = _cfg(Config, generator=name, **over)
    G0 = make_generator(name, cfg, cfg.pyramid(), ndim=3)
    G0.init(torch.Generator().manual_seed(0))
    for _ in range(n_stages - 1):
        G0.init_next_stage()
    gvars = flax_vars.generator(G0)
    G = make_generator(name, cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(1))
    convert.load_generator(G, gvars)
    for (k, a), b in zip(G0.state_dict().items(), G.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    G.requires_grad_(True)
    return jcfg, jG, gvars, cfg, G


def _stage_noises(key, G, batch=BATCH):
    """The rand forward's stage noises under ``key``
    (generators.py:466-469, 525-528): one split a stage from 1 on, shaped
    like the stage's resized input."""
    noises = [None]
    for idx in range(1, len(G.body)):
        key, k_n = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(
            k_n, G._noise_shape(idx, batch)), np.float32))
    return noises


def _stage_noises_f64(key, G):
    """The same draws as the exact reference makes them (float64)."""
    noises = [None]
    for idx in range(1, len(G.body)):
        key, k_n = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(
            k_n, G._noise_shape(idx, BATCH), jnp.float64)))
    return noises


def test_n002_init_statistics():
    """N(0, 0.02) conv kernels with PyTorch's uniform bias, N(1, 0.02)
    BatchNorm scales (blocks.py:69-76); the torch mode keeps 1."""
    g = torch.Generator().manual_seed(2)
    conv = blocks.ConvND(64, 64, 3, 1, ndim=3, init_mode="n002")
    conv.reset_parameters(g)
    w = conv.weight.detach().numpy()
    assert abs(w.mean()) < 1e-3 and abs(w.std() - 0.02) < 5e-4
    bound = 1 / np.sqrt(27 * 64)
    b = conv.bias.detach().numpy()
    assert np.abs(b).max() <= bound and b.std() > bound / 3
    block = blocks.ConvBlock(64, 512, 3, 1, ndim=3, init_mode="n002")
    block.reset_parameters(g)
    scale = block.norm.weight.detach().numpy()
    assert abs(scale.mean() - 1) < 5e-3 and abs(scale.std() - 0.02) < 3e-3
    assert not block.norm.bias.detach().numpy().any()
    plain = blocks.ConvBlock(3, 8, 3, 1, ndim=3)
    assert (plain.norm.weight.detach().numpy() == 1).all()
    with pytest.raises(ValueError):
        blocks.ConvND(3, 8, 3, 1, init_mode="nope")
    # the baselines' modules take it; the main path's do not
    D = networks.WDiscriminatorBaselines(3, 8, 3, 1, 2, ndim=3)
    assert D.head.norm is None and D.tail.init_mode == "n002"
    assert all(b.conv.init_mode == "n002" for b in D.body)


def test_critic_and_stages_match_jax():
    """WDiscriminatorBaselines (its running statistics too), CSGStage and
    SGStage in train mode."""
    x = _x((2, 4, 6, 8, 3), 3)
    D = networks.WDiscriminatorBaselines(3, 8, 3, 1, 2, ndim=3)
    D.reset_parameters(torch.Generator().manual_seed(4))
    dvars = flax_vars.critic(D)
    jD = jnet.WDiscriminatorBaselines(nfc=8, nc_im=3, ker_size=3,
                                      padd_size=1, num_layer=2, ndim=3)
    with exact_reference():
        ref, upd = jax.jit(lambda v, x: jD.apply(
            v, x, True, mutable=["batch_stats"]))(_f64(dvars), _f64(x))
    D2 = make_discriminator("WDiscriminatorBaselines",
                            Config(nfc=8, num_layer=2), ndim=3)
    convert.load_discriminator(D2, dvars)
    with torch.no_grad():
        got = D2(to_model_layout(x), update_stats=True)
    assert tuple(to_public_layout(got).shape) == ref.shape
    _close(to_public_layout(got).numpy(), ref, "critic")
    for i, block in enumerate(D2.body):
        st = upd["batch_stats"][f"block{i}"]["norm"]
        _close(block.norm.running_mean.numpy(), st["mean"], f"mean {i}")
        _close(block.norm.running_var.numpy(), st["var"], f"var {i}")

    for m, jm, tree, inp in (
            (networks.CSGStage(8, 3, 2, ndim=3),
             jnet.CSGStage(nfc=8, ker_size=3, num_layer=2, ndim=3),
             flax_vars.csg_stage, _x((2, 8, 10, 12, 8), 5)),
            (networks.SGStage(8, 3, 3, 2, ndim=3),
             jnet.SGStage(nfc=8, nc_im=3, ker_size=3, num_layer=2, ndim=3),
             flax_vars.conv_stack, _x((2, 10, 12, 14, 3), 5))):
        m.reset_parameters(torch.Generator().manual_seed(6))
        with exact_reference():
            ref, _ = jax.jit(lambda v, x: jm.apply(
                v, x, True, mutable=["batch_stats"]))(_f64(tree(m)),
                                                      _f64(inp))
        with torch.no_grad():
            got = to_public_layout(m(to_model_layout(inp), True))
        # VALID convs: every axis shrinks by 2 a conv
        assert tuple(got.shape) == ref.shape
        _close(got.numpy(), ref, type(m).__name__)


@pytest.mark.parametrize("name", ["GeneratorCSG", "GeneratorSG"])
def test_generators_match_jax_in_rand_and_rec(name):
    jcfg, jG, gvars, cfg, G = _models(name)
    pyr = cfg.pyramid()
    noise_init = np.random.default_rng(7).standard_normal(
        (BATCH, *pyr.shape3d(0), 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    with exact_reference():
        amps = jnp.asarray(AMPS, jnp.float64)
        fwd = jax.jit(lambda gv, z: (
            jG.apply(gv, amps, key, noise_init=z, mode="rand",
                     train=True)[0],
            jG.apply(gv, amps, key, noise_init=z, mode="rec",
                     train=True)[0]))
        rand, rec = fwd(_f64(gvars), _f64(noise_init))
        noises = _stage_noises_f64(key, G)
    with torch.no_grad():
        got_rand = G.apply(AMPS, noise_init=noise_init, mode="rand",
                           noises=noises)
        got_rec = G.apply(AMPS, noise_init=noise_init, mode="rec")
    want = (BATCH, *pyr.shape3d(SCALE), 3)
    assert tuple(got_rand.shape) == tuple(got_rec.shape) == want
    _close(got_rand.numpy(), rand, "rand")
    _close(got_rec.numpy(), rec, "rec")
    # its own draws: the geometry of the JAX draws
    own = G.draw_stage_noises(BATCH)
    assert [None if n is None else tuple(n.shape) for n in own] == \
        [None if n is None else n.shape for n in noises]
    # growth copies the last stage
    n = len(G.body)
    G.init_next_stage()
    assert len(G.body) == n + 1 and all(
        torch.equal(a, b) for a, b in zip(G.body[-1].state_dict().values(),
                                          G.body[-2].state_dict().values()))


@pytest.mark.parametrize("scale,n_body,has_head,depth",
                         [(0, 1, True, 1), (1, 2, True, 1), (2, 3, True, 3),
                          (4, 5, True, 2), (3, 4, False, 1),
                          (5, 6, False, 3)])
def test_baselines_group_plan_matches_jax(scale, n_body, has_head, depth):
    ours = optim.baselines_group_plan(_cfg(Config, train_depth=depth),
                                      scale, n_body, has_head)
    theirs = joptim.baselines_group_plan(_cfg(JConfig, train_depth=depth),
                                         scale, n_body, has_head)
    assert ours == theirs


def _assert_params_after_adam(module, want: dict, lr_max, what):
    off = total = 0
    for name, p in module.named_parameters():
        got, exp = p.detach().numpy(), want[name]
        diff = np.abs(got - exp)
        assert diff.max() <= 2 * lr_max * 1.01 + ATOL, (what, name,
                                                        diff.max())
        off += int(np.sum(diff > ATOL + RTOL * np.abs(exp)))
        total += diff.size
    assert off <= 0.005 * total, (what, off, total)


def _state(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("name,critic,dsteps,gsteps,alpha", [
    ("GeneratorCSG", "WDiscriminatorBaselines", 1, 1, 10.0),
    ("GeneratorSG", "WDiscriminator3D", 2, 2, 0.0)])
def test_baseline_step_matches_jax(name, critic, dsteps, gsteps, alpha):
    over = dict(Dsteps=dsteps, Gsteps=gsteps, alpha=alpha,
                discriminator=critic)
    jcfg, jG, gvars, cfg, G = _models(name, **over)
    cfg.scale_idx = jcfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    D = make_discriminator(critic, cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(9))
    dvars = flax_vars.critic(D)
    jD = jmake_d(critic, jcfg, 3)
    ml, bl, lrs = joptim.baselines_group_plan(jcfg, SCALE, SCALE + 1,
                                              jG.has_head_tail)
    tx_g, opt_g_j = joptim.build_g_optimizer(
        jcfg, joptim.gparams_view(gvars), ml, bl, lrs, grad_clip=None)
    tx_d, opt_d_j = joptim.build_d_optimizer(jcfg, dvars["params"])
    fns = make_baseline_steps(jG, jD, jcfg, tx_g, tx_d)
    real = _x((BATCH, *pyr.shape3d(SCALE), 3), 10)
    rng = np.random.default_rng(11)
    noise_init = rng.standard_normal((BATCH, *pyr.shape3d(0), 3)).astype(
        np.float32)
    z_init = rng.standard_normal(noise_init.shape).astype(np.float32)
    key = jax.random.PRNGKey(12)
    gv_new, dv_new, _, _, metrics_ref = fns["step"](
        _copy(gvars), _copy(dvars), opt_g_j, opt_d_j, real, noise_init,
        z_init, jnp.asarray(AMPS), key)
    rmse_ref, _ = fns["calibrate"](_copy(gvars), real, z_init,
                                   jnp.asarray(AMPS), key)

    rmse = steps.calibrate_baselines(copy.deepcopy(G), real, z_init, AMPS)
    _close(float(rmse), float(rmse_ref), "calibrate")
    k_gp = jax.random.fold_in(key, 0)
    alphas = [float(jax.random.uniform(jax.random.fold_in(k_gp, j), ()))
              for j in range(dsteps)]
    D2 = make_discriminator(critic, cfg, 3)
    convert.load_discriminator(D2, dvars)
    metrics = steps.baseline_step(
        G, D2, optim.build_g_optimizer(cfg, G, SCALE),
        optim.build_d_optimizer(cfg, D2), cfg, real, noise_init, z_init,
        AMPS, noises=_stage_noises(key, G), alphas=alphas)
    assert set(metrics) == set(metrics_ref)
    for k, value in metrics_ref.items():
        _close(float(metrics[k]), float(value), k)
    G_ref = make_generator(name, cfg, pyr, ndim=3).init()
    convert.load_generator(G_ref, jax.tree_util.tree_map(np.asarray, gv_new))
    D_ref = make_discriminator(critic, cfg, 3)
    convert.load_discriminator(D_ref,
                               jax.tree_util.tree_map(np.asarray, dv_new))
    G_ref, D_ref = _state(G_ref), _state(D_ref)
    for module, ref, lr in ((G, G_ref, gsteps * max(lrs.values())),
                            (D2, D_ref, dsteps * cfg.lr_d)):
        _assert_params_after_adam(module, ref, lr, type(module).__name__)
        for k, buf in module.named_buffers():   # BN statistics, u/v
            _close(buf.numpy(), ref[k], k)
