"""``--wpack`` through the port (``ops/wpack.py``, ``models/packed.py`` and
their routing in ``models/generators.py`` and ``train/steps.py``) against
the JAX package's ``--wpack`` on the CPU, the counterpart of
tests/test_wpack.py on seeded port models handed to the JAX package as
flax trees (``torch_port_flax``), with JAX's draws injected:

* each op of ``ops/wpack.py`` against ``hpvaegan_tpu.ops.wpack``'s, 2D and
  3D, ``conv_packed`` against a direct conv (f32 and bf16), the gates;
* ``stage_apply_packed`` (train and eval, the running statistics moved)
  and ``wdisc_apply_packed`` (forward, input and parameter gradients,
  the critic loss with the WGAN-GP) against the JAX functions and the
  port's unpacked modules;
* whole GAN steps (the critic step with the GP through the packed critic,
  then the generator step) against JAX's ``--wpack`` steps, 3D, 2D and
  ``GeneratorVAE_nb``, with ``WPACK_MIN_W`` lowered to 8 in both packages
  so that the tiny pyramid packs (tests/test_wpack.py:172-243 does the
  same);
* ``--remat`` and ``--remat-blocks`` bit-equal to the plain packed step;
* the routing: inside a packed module no K1/K2 wrapper is called, and a
  GAN step's calls elsewhere follow ``chip_smoke.gan_step_launches(...,
  wpack=True)``;
* ``cli.train_video --wpack``, sampling its run, and a GAN step over 1x2
  and 2x1 gloo ranks against one process.

Tolerances: f32 ``rtol=2e-3, atol=2e-4`` (``torch_port_fast``); parameters
after one Adam step within ``2 * lr`` (``torch_port_fast``); bf16 convs
within 2 bf16 ulps of ``max(1, max|ref|)`` (the product rounded once and
the bias added in bf16, each a possible 1-ulp flip, as
``models/blocks._stock_conv``); packed against the port's unpacked path
at the f32 bar (the sums run in another order)."""
import collections
import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import test_torch_port_vae_nb as tnb
import torch_port_fast as fast
import torch_port_flax as flax_vars
import torch_port_ranks as ranks
from hpvaegan_tpu.losses import calc_gradient_penalty as j_gp
from hpvaegan_tpu.models import packed as jpacked
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.ops import wpack as jw
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.losses import calc_gradient_penalty
from hpvaegan_tpu_torch.models import blocks, generators, networks, packed
from hpvaegan_tpu_torch.models.generators import (to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.ops import wpack as tw
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
from hpvaegan_tpu_torch.utils.logger import kept_logging
from torch_port_runs import make_clip, one_torch_thread, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the structure-derived launch counts)

LAMBDA = 0.1
SCALE = 3
LEVELS = {True: dict(remat=True), "blocks": dict(remat_blocks=True)}
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture
def min_w(monkeypatch):
    """``WPACK_MIN_W`` lowered to 8 in both packages: every level of the
    tiny pyramid (W 8-16) packs."""
    monkeypatch.setattr(packed, "WPACK_MIN_W", 8)
    monkeypatch.setattr(jpacked, "WPACK_MIN_W", 8)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t) -> np.ndarray:
    """A model-layout tensor as a public-layout (NTHWC / NHWC) array."""
    return to_public_layout(t.detach()).float().numpy()


def _torch_kernel(k: np.ndarray) -> torch.Tensor:
    """flax ``(*k, I, O)`` -> torch ``(O, I, *k)``."""
    nd = k.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(k, (nd + 1, nd, *range(nd)))))


def _grads(module):
    return {n: (p.grad.clone() if p.grad is not None
                else torch.zeros_like(p))
            for n, p in module.named_parameters()}


def _close_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for name, t in got.items():
        fast.close(t.detach().numpy(), want[name].detach().numpy(), name)


# ---------------------------------------------------------------------------
# ops/wpack.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
def test_ops_match_jax_and_a_direct_conv(ndim):
    shape = (2, 4, 6, 12, 5) if ndim == 3 else (2, 6, 12, 5)   # NTHWC
    x = _x(shape, ndim)
    k = _x((3,) * ndim + (5, 7), 10 + ndim) * 0.1
    b = _x((7,), 20 + ndim)
    xt = to_model_layout(x)
    fmt = torch.channels_last_3d if ndim == 3 else torch.channels_last

    q = tw.qpack(xt)
    assert q.is_contiguous(memory_format=fmt)
    np.testing.assert_array_equal(_np(q), np.asarray(jw.qpack(x)))
    # the P-rep of x is a fold of its W pairs
    p = x.reshape(*shape[:-2], shape[-2] // 2, 2 * shape[-1])
    pt = to_model_layout(p)
    unpacked = tw.unpack_p(pt)
    assert unpacked.data_ptr() == pt.data_ptr()    # a view
    np.testing.assert_array_equal(_np(unpacked), np.asarray(jw.unpack_p(p)))
    np.testing.assert_array_equal(_np(unpacked), x)
    np.testing.assert_array_equal(_np(tw.rephase(pt)),
                                  np.asarray(jw.rephase(p)))
    np.testing.assert_array_equal(_np(tw.rephase(pt)), _np(q))

    kt = _torch_kernel(k)
    kq = tw.pack_kernel(kt)
    assert tuple(kq.shape) == (14, 10, *(3,) * (ndim - 1), 2)
    np.testing.assert_array_equal(
        np.transpose(kq.numpy(), (*range(2, 2 + ndim), 1, 0)),
        np.asarray(jw.pack_kernel(k)))
    bt = torch.from_numpy(b)
    np.testing.assert_array_equal(tw.pack_bias(bt).numpy(),
                                  np.asarray(jw.pack_bias(b)))

    y = tw.conv_packed(q, kt, bt)
    fast.close(_np(y), np.asarray(jw.conv_packed(jw.qpack(x), k, b)))
    conv = F.conv3d if ndim == 3 else F.conv2d
    fast.close(_np(tw.unpack_p(y)), _np(conv(xt, kt, bt, padding=1)))


def test_bf16_conv_packed_matches_the_stock_bf16_conv_and_jax():
    x = _x((2, 4, 6, 12, 8), 30)
    k = _x((3, 3, 3, 8, 8), 31) * 0.2
    b = _x((8,), 32)
    xt, kt, bt = to_model_layout(x), _torch_kernel(k), torch.from_numpy(b)
    got = tw.unpack_p(tw.conv_packed(tw.qpack(xt), kt, bt, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    stock = blocks._stock_conv(xt, kt, bt, 3, 1, 1, torch.bfloat16)
    ref = jw.unpack_p(jw.conv_packed(jw.qpack(x), k, b, dtype=jnp.bfloat16))
    for want in (_np(stock), np.asarray(ref, np.float32)):
        bar = 2 * BF16_ULP * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(_np(got) - want).max()) <= bar


def test_the_gates_match_jax():
    for w in (128, 127, 102, 256, 129):
        assert tw.can_wpack((2, 3, 4, 6, w), 128) == \
            jw.can_wpack((2, 4, 6, w, 3), 128)
        for on, ker, padd in ((True, 3, 1), (False, 3, 1), (True, 5, 1),
                              (True, 3, 0)):
            cfg = Config(wpack=on, ker_size=ker, padd_size=padd)
            assert packed.wpack_ok(cfg, (2, 3, 4, 6, w)) == \
                jpacked.wpack_ok(cfg, (2, 4, 6, w, 3))
    assert packed.wpack_ok(Config(wpack=True), (2, 3, 144, 256))   # 2D


# ---------------------------------------------------------------------------
# models/packed.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("train", [True, False])
def test_stage_matches_jax_and_the_unpacked_stage(ndim, train):
    stage = networks.Stage(8, 3, 3, 1, 2, ndim=ndim)
    stage.reset_parameters(torch.Generator().manual_seed(1))
    norms = [("head", stage.head.norm)] + [
        (f"block{i}", b.norm) for i, b in enumerate(stage.blocks)]
    with torch.no_grad():   # distinct running statistics: eval reads them
        for i, (_, norm) in enumerate(norms):
            norm.running_mean.add_(0.01 * (i + 1))
            norm.running_var.add_(0.02 * (i + 1))
    svars = flax_vars.conv_stack(stage)
    x = _x((2, 4, 6, 12, 3) if ndim == 3 else (2, 6, 12, 3), 2)
    want, jvars = jpacked.stage_apply_packed(svars, jnp.asarray(x), train,
                                             num_layer=2)
    stock = copy.deepcopy(stage)
    with torch.no_grad():
        got = packed.stage_apply_packed(stage, to_model_layout(x), train,
                                        update_stats=train)
        ref = stock(to_model_layout(x), train, update_stats=train)
    fast.close(_np(got), np.asarray(want), "vs jax")
    fast.close(_np(got), _np(ref), "vs the unpacked stage")
    stock_norms = dict([("head", stock.head.norm)] + [
        (f"block{i}", b.norm) for i, b in enumerate(stock.blocks)])
    for name, norm in norms:
        stats = jvars["batch_stats"][name]["norm"]
        for buf, key in (("running_mean", "mean"), ("running_var", "var")):
            got_buf = getattr(norm, buf).numpy()
            fast.close(got_buf, np.asarray(stats[key]), f"{name} {key}")
            fast.close(got_buf, getattr(stock_norms[name], buf).numpy(),
                       f"{name} {key} vs the unpacked stage")
    if not train:   # eval mode moves nothing
        np.testing.assert_array_equal(norms[0][1].running_mean.numpy(),
                                      svars["batch_stats"]["head"]["norm"]
                                      ["mean"])


def _critic_loss(D, forward, real, fake, alpha, gp_forward=None):
    """``-mean(D(real)) + GP`` backpropagated into ``D``; the GP through
    ``gp_forward`` (``forward`` by default)."""
    D.zero_grad(set_to_none=True)
    x_real, x_fake = to_model_layout(real), to_model_layout(fake)
    gp = calc_gradient_penalty(gp_forward or forward, x_real, x_fake, LAMBDA,
                               alpha)
    loss = -forward(x_real).mean() + gp
    loss.backward()
    return float(loss.detach()), _grads(D)


@pytest.mark.parametrize("ndim", [2, 3])
def test_critic_matches_jax_and_the_unpacked_critic(ndim):
    """Forward, input gradients (the WGAN-GP's inner pass), and the
    critic loss with the GP: its second order through the packed
    critic's folds."""
    jD, dvars, port_critic = fast.critics(ndim)
    shape = (2, 4, 6, 12, 3) if ndim == 3 else (2, 6, 12, 3)
    real, fake = _x(shape, 40), _x(shape, 41)

    def jfwd(dv, z):
        return jpacked.wdisc_apply_packed(dv, z, num_layer=2)

    D, stock = port_critic(), port_critic()
    xt = to_model_layout(real).requires_grad_(True)
    y = packed.wdisc_apply_packed(D, xt)
    fast.close(_np(y), np.asarray(jfwd(dvars, real)), "forward vs jax")
    fast.close(_np(y), _np(stock(to_model_layout(real))),
               "forward vs the unpacked critic")
    (gx,) = torch.autograd.grad(y.square().sum(), xt)
    jgx = jax.grad(lambda z: jnp.sum(jfwd(dvars, z) ** 2))(real)
    fast.close(_np(gx), np.asarray(jgx), "input grads vs jax")

    key = jax.random.PRNGKey(42)
    alpha = float(jax.random.uniform(key, ()))
    v, g = _critic_loss(D, lambda z: packed.wdisc_apply_packed(D, z), real,
                        fake, alpha)
    v0, g0 = _critic_loss(stock, lambda z: stock(z, use_kernels=False),
                          real, fake, alpha)

    def jloss(params):
        dv = {**dvars, "params": params}
        return (-jnp.mean(jfwd(dv, real))
                + j_gp(lambda z: jfwd(dv, z), real, fake, LAMBDA, key))

    jv, jg = jax.value_and_grad(jloss)(dvars["params"])
    fast.close(v, float(jv), "loss vs jax")
    fast.close(v, v0, "loss vs the unpacked critic")
    _close_dicts(g, convert.critic_moments(D, dvars, fast.np_tree(jg)))
    _close_dicts(g, g0)


def test_the_packed_modules_launch_no_kernel():
    """At nfc 64 a ``--pconv-all`` stage (its block kernels in THWIO) and
    a ``--pconv --pfuse`` critic run packed on stock convs: no K1 or K2
    wrapper is called, forward or backward, the GP's second order
    included, and they compute what the trainer's unpacked routes compute
    (the critic on K2 and K1, its GP's body on K1 unfused)."""
    stage = networks.Stage(64, 3, 3, 1, 2, ndim=3, pconv=True)
    stage.reset_parameters(torch.Generator().manual_seed(3))
    assert stage.blocks[0].conv.kernel_route
    D = networks.WDiscriminator(3, 64, 3, 3, ndim=3, pconv=True, pfuse=True)
    D.reset_parameters(torch.Generator().manual_seed(4))
    x, fake = _x((2, 3, 5, 8, 3), 5), _x((2, 3, 5, 8, 3), 6)
    routed = {}
    for route in ("packed", "kernels"):
        cp.counts.reset()
        cf.counts.reset()
        s, d = copy.deepcopy(stage), copy.deepcopy(D)
        xt = to_model_layout(x).requires_grad_(True)
        if route == "packed":
            y = packed.stage_apply_packed(s, xt, True)
            loss, g = _critic_loss(d, lambda z: packed.wdisc_apply_packed(
                d, z), x, fake, 0.3)
        else:
            y = s(xt, True)
            loss, g = _critic_loss(d, d, x, fake, 0.3,
                                   lambda z: d(z, fuse=False))
        y.square().sum().backward()
        routed[route] = (_np(y), _np(xt.grad), loss, g, _grads(s),
                         cp.counts.plain_calls, cf.counts.plain_calls)
    got, ref = routed["packed"], routed["kernels"]
    assert got[5:] == (0, 0)
    assert ref[5] > 0 and ref[6] > 0
    for a, b, what in zip(got[:3], ref[:3], ("y", "dx", "critic loss")):
        fast.close(a, b, what)
    _close_dicts(got[3], ref[3])
    _close_dicts(got[4], ref[4])


# ---------------------------------------------------------------------------
# the steps against JAX's --wpack steps
# ---------------------------------------------------------------------------

def _adam_mu(opt_state):
    mus = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(mus) == 1
    return fast.np_tree(mus[0])


def _assert_critic_moments(D, opt_d, dvars, opt_d_jax):
    """The critic's Adam first moments equal the JAX step's: the critic
    step's gradients, the GP's included, agree."""
    want = convert.critic_moments(D, dvars, _adam_mu(opt_d_jax))
    names = {id(p): n for n, p in D.named_parameters()}
    for p, state in opt_d.state.items():
        fast.close(state["exp_avg"].numpy(), want[names[id(p)]].numpy(),
                   names[id(p)])
    assert len(opt_d.state) == len(names)


def _assert_metrics_close(metrics, ref, D, D_ref, cfg):
    """The step's metrics at the f32 bar; ``errG`` and the total read the
    critic after its Adam step, whose tail bias has a gradient of zero
    in exact arithmetic (the WGAN terms and the penalty do not move with
    it): rounding gives it either sign in either package, Adam's first
    step then moves it by ``lr_d`` one way or the other, and ``errG``
    moves by that difference times ``disc_loss_weight`` (its derivative
    in the tail bias is exactly that)."""
    moved = cfg.disc_loss_weight * float(
        (D.tail.bias - D_ref.tail.bias).detach().abs().max())
    for name, value in ref.items():
        extra = moved if name in ("errG", "loss") else 0.0
        got, want = float(metrics[name]), float(value)
        assert abs(got - want) <= fast.ATOL + fast.RTOL * abs(want) + extra, (
            name, got, want, extra)


@pytest.mark.parametrize("ndim", [3, 2])
def test_gan_step_matches_jax(ndim, min_w):
    """Scale 3 of the tiny model, every stage and the critic packed."""
    over = dict(wpack=True)
    jcfg, jG, gvars = fast.jax_generator(SCALE, ndim=ndim, **over)
    jD, dvars, port_critic = fast.critics(ndim)
    fns, opt_g_j, opt_d_j, lrs = fast.jax_steps(jcfg, jG, jD, gvars, SCALE,
                                                dvars)
    cfg, G = fast.port_generator(gvars, SCALE, ndim=ndim, **over)
    D = port_critic()
    pyr = fast.pyramid(cfg, ndim)
    real, real_zero, noise_init = fast.data(pyr, ndim, SCALE, seed=43)
    key = jax.random.PRNGKey(44)
    amps = fast.AMPS[:SCALE + 1]
    gv_new, dv_new, opt_g_j, opt_d_j, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g_j, opt_d_j,
        real, real_zero, noise_init, jnp.asarray(amps), key)
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    calls = collections.Counter()
    stage_fn, critic_fn = generators.stage_apply_packed, \
        steps.wdisc_apply_packed

    def spy(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generators, "stage_apply_packed", spy("stage", stage_fn))
        mp.setattr(steps, "wdisc_apply_packed", spy("critic", critic_fn))
        opt_g = optim.build_g_optimizer(cfg, G, SCALE)
        opt_d = optim.build_d_optimizer(cfg, D)
        metrics = steps.gan_step(
            G, D, opt_g, opt_d, cfg, real, real_zero, noise_init, amps,
            noises=fast.noises_of(k_fake, pyr, ndim, SCALE,
                                  lambda i: ndim == 2
                                  or cfg.vae_levels <= i + 1),
            eps=fast.eps_of(k_rec, pyr, ndim),
            alpha=float(jax.random.uniform(k_gp, ())))
    # three generator forwards of every stage; the critic on [real, fake],
    # in the GP, and on the generator's fake
    assert calls == {"stage": 3 * SCALE, "critic": 3}
    _assert_critic_moments(D, opt_d, dvars, opt_d_j)
    fast.assert_first_moments_match(G, opt_g, gvars, opt_g_j, SCALE,
                                    ndim=ndim, **over)
    D_ref = port_critic(fast.np_tree(dv_new))
    fast.assert_buffers_close(D, D_ref)
    fast.assert_params_after_adam(D, D_ref, cfg.lr_d)
    _assert_metrics_close(metrics, metrics_ref, D, D_ref, cfg)
    _, ref = fast.port_generator(fast.np_tree(gv_new), SCALE, ndim=ndim,
                                 **over)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, max(lrs.values()))


def test_vae_nb_gan_step_matches_jax(min_w):
    """``GeneratorVAE_nb`` at nfc 64 under ``--pconv --pconv-all --pfuse
    --wpack``: every stage and the critic pack, so no K1 or K2 wrapper
    is called."""
    over = dict(tnb.WIDE, wpack=True)
    jcfg, jG, gvars = tnb._jax_model(tnb.SCALE, **over)
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3)
    pyr = jcfg.pyramid()
    D0 = networks.WDiscriminator(3, 64, 3, jcfg.num_layer, ndim=3)
    D0.reset_parameters(torch.Generator().manual_seed(45))
    dvars = flax_vars.critic(D0)
    fns, opt_g_j, opt_d_j, lrs = tnb._jax_steps(jcfg, jG, jD, gvars,
                                                tnb.SCALE, dvars)
    cfg, G = tnb._port_model(gvars, **over)
    D = networks.WDiscriminator(3, 64, 3, cfg.num_layer, ndim=3, pconv=True,
                                pfuse=True)
    convert.load_discriminator(D, dvars)
    real, real_zero = tnb._data(pyr, tnb.SCALE, seed=46)
    noise_init = _x((tnb.BATCH, *pyr.shape3d(0), cfg.latent_dim), 47)
    key = jax.random.PRNGKey(48)
    amps = tnb.AMPS[:tnb.SCALE + 1]
    gv_new, dv_new, _, opt_d_j, metrics_ref = fns["gan_step"](
        tnb._copy(gvars), tnb._copy(dvars), opt_g_j, opt_d_j, real,
        real_zero, noise_init, jnp.asarray(amps), key)
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    latents, noises = tnb._rand_draws(k_fake, pyr, cfg.latent_dim,
                                      tnb.SCALE)
    cp.counts.reset()
    cf.counts.reset()
    opt_d = optim.build_d_optimizer(cfg, D)
    metrics = steps.gan_step(
        G, D, optim.build_g_optimizer(cfg, G, tnb.SCALE), opt_d, cfg, real,
        real_zero, noise_init, amps, noises=noises,
        eps=tnb._rec_eps(k_rec, pyr, cfg.latent_dim),
        alpha=float(jax.random.uniform(k_gp, ())), latents=latents)
    assert cp.counts.plain_calls == 0 and cf.counts.plain_calls == 0
    _assert_critic_moments(D, opt_d, dvars, opt_d_j)
    D_ref = copy.deepcopy(D)
    convert.load_discriminator(D_ref, tnb._np(dv_new))
    _assert_metrics_close(metrics, metrics_ref, D, D_ref, cfg)
    _, G_ref = tnb._port_model(tnb._np(gv_new), **over)
    tnb._assert_buffers_close(G, G_ref)
    tnb._assert_params_after_adam(G, G_ref, max(lrs.values()))


# ---------------------------------------------------------------------------
# remat, and the routing against the kernel routes
# ---------------------------------------------------------------------------

def _port_step(**over):
    """One GAN step of a seeded tiny model from fixed draws; returns the
    generator and the critic after it, and the generator's Adam."""
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
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    metrics = steps.gan_step(G, D, opt_g, optim.build_d_optimizer(cfg, D),
                             cfg, real, real_zero, noise_init, fast.AMPS,
                             generator=torch.Generator().manual_seed(2))
    return (G, D), opt_g, metrics


@pytest.mark.parametrize("level", [True, "blocks"])
def test_remat_is_bit_equal_to_the_plain_packed_step(level, min_w):
    """Weights, running statistics, spectral vectors, metrics and Adam's
    first moments after a remat'd packed step equal the plain packed
    step's bit for bit: the recompute repeats the same operations and
    moves the statistics once."""
    plain, opt, m0 = _port_step(wpack=True)
    remat, opt_r, m1 = _port_step(wpack=True, **LEVELS[level])
    for a, b in zip(remat, plain):
        want = b.state_dict()
        for name, t in a.state_dict().items():
            assert torch.equal(t, want[name]), name
    assert {k: float(v) for k, v in m0.items()} == \
        {k: float(v) for k, v in m1.items()}
    for a, b in zip(opt.param_groups, opt_r.param_groups):
        for p, q in zip(a["params"], b["params"]):
            assert torch.equal(opt.state[p]["exp_avg"],
                               opt_r.state[q]["exp_avg"])
    # packing changed the step: the unpacked one differs in its last bits
    unpacked, _, _ = _port_step()
    assert any(not torch.equal(t, unpacked[0].state_dict()[n])
               for n, t in plain[0].state_dict().items())


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


@pytest.mark.parametrize("mode,level,min_width", [
    ("plain", False, 14), ("plain", False, 18), ("plain", "blocks", 14),
    ("hoist", True, 14), ("fused", False, 14)])
def test_packing_takes_precedence_at_qualifying_shapes_only(
        kernel_calls, monkeypatch, mode, level, min_width):
    """At nfc 64 under ``--pconv --pconv-all --pfuse --wpack`` (4 stages,
    3 layers; W 10, 12, 14, 16): with ``WPACK_MIN_W`` 14 the top two
    stages and the critic pack and launch nothing, while stages 0 and 1
    keep K1; with 18 nothing packs and the step launches what it does
    without ``--wpack``.  The calls equal
    ``chip_smoke.gan_step_launches(..., wpack=True)``."""
    monkeypatch.setattr(packed, "WPACK_MIN_W", min_width)
    stages, layers, vae_levels = 4, 3, 2
    flags = {"plain": {}, "hoist": dict(fast_grads=True, hoist_prefix=True),
             "fused": dict(fast_grads=True, fused_forwards=True)}[mode]
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=layers, enc_blocks=1, vae_levels=vae_levels,
                 pconv=True, pconv_all=True, pfuse=True, wpack=True,
                 **flags, **(LEVELS[level] if level else {}))
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = stages
    pyr = cfg.pyramid()
    widths = [pyr.shape3d(i)[-1] for i in range(stages + 1)]
    assert widths == [8, 10, 12, 14, 16]
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
    kw = dict(stages=stages, num_layer=layers, vae_levels=vae_levels,
              train_depth=cfg.train_depth, remat=level, widths=widths)
    want = chip_smoke.gan_step_launches(mode, wpack=True, **kw)
    got = {k: kernel_calls[k] for k in ("fwd", "pair", "dx", "dw")}
    assert got == {"fwd": want["conv3d64_fwd"],
                   "pair": want["conv3d64_pair"],
                   "dx": want["conv3d64_dx"], "dw": want["conv3d64_dw"]}
    unpacked = chip_smoke.gan_step_launches(mode, **kw)
    assert got["fwd"] > 0
    if min_width > widths[-1]:
        assert want == unpacked
    else:
        assert want["conv3d64_pair"] == 0 < unpacked["conv3d64_pair"]


# ---------------------------------------------------------------------------
# the entry points, and the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_clip(tmp_path_factory.mktemp("clip"))


def _netG(exp):
    return torch.load(os.path.join(exp, "netG"), map_location="cpu",
                      weights_only=True)


def test_train_video_wpack_trains_packed_and_samples_packed(clip, tmp_path,
                                                            monkeypatch):
    """``cli.train_video --wpack`` with ``WPACK_MIN_W`` 12 (levels 2-4 of
    the tiny pyramid pack): the packed stages and critic run, no no-op
    line is logged, the run ends within the step bar of the run without
    the flag (10 Adam steps of ``lr`` 5e-4 a parameter at most), and its
    ``config.json`` carries ``wpack`` to ``SamplerSession``, whose
    packed samples equal the unpacked session's at the f32 bar."""
    monkeypatch.setattr(packed, "WPACK_MIN_W", 12)
    calls = collections.Counter()
    stage_fn = generators.stage_apply_packed

    def counted(stage, x, *a, **kw):
        calls[x.shape[-1]] += 1
        return stage_fn(stage, x, *a, **kw)

    plain = port_run(clip, tmp_path / "plain")
    monkeypatch.setattr(generators, "stage_apply_packed", counted)
    exp = port_run(clip, tmp_path / "wpack", "--wpack")
    assert set(calls) == {12, 14, 16}
    with open(os.path.join(exp, "logbook.txt")) as f:
        assert "--wpack" not in f.read()
    got, want = _netG(exp), _netG(plain)
    assert got["scale"] == want["scale"] == 4
    np.testing.assert_allclose(got["noise_amps"], want["noise_amps"],
                               rtol=2e-3)
    for name, v in want["gvars"].items():
        diff = float((got["gvars"][name] - v).abs().max())
        assert diff <= 2 * 5e-4 * 10 + 2e-4, (name, diff)
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["wpack"] is True

    calls.clear()
    sess = ranks.port_session(os.path.join(exp, "netG"))
    assert sess.cfg.wpack
    packed_out = sess.sample_batch(torch.Generator().manual_seed(9))
    assert set(calls) == {12, 14, 16}
    sess.cfg.wpack = False
    fast.close(packed_out, sess.sample_batch(
        torch.Generator().manual_seed(9)), "packed vs unpacked samples")


def test_train_video_without_wpack_packs_nothing(clip, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(packed, "WPACK_MIN_W", 8)

    def refuse(*a, **kw):
        raise AssertionError("packed without --wpack")

    monkeypatch.setattr(generators, "stage_apply_packed", refuse)
    monkeypatch.setattr(steps, "wdisc_apply_packed", refuse)
    with kept_logging():
        port_run(clip, tmp_path)


@pytest.mark.parametrize("generator", ["GeneratorCSG", "GeneratorSG"])
def test_the_baselines_never_pack(generator, monkeypatch):
    """``baseline_step`` with ``--wpack`` and every W qualifying: the
    stages and the SN critic run unpacked, as the JAX package's
    baselines steps pass no ``cfg`` to the packed routing."""
    monkeypatch.setattr(packed, "WPACK_MIN_W", 8)

    def refuse(*a, **kw):
        raise AssertionError("a baseline packed")

    monkeypatch.setattr(packed, "stage_apply_packed", refuse)
    monkeypatch.setattr(generators, "stage_apply_packed", refuse)
    monkeypatch.setattr(steps, "wdisc_apply_packed", refuse)
    cfg = fast.cfg_of(Config, generator=generator, wpack=True)
    cfg.scale_idx = 2
    pyr = cfg.pyramid()
    G = make_generator(generator, cfg, pyr, ndim=3)
    G.init(torch.Generator().manual_seed(0))
    for _ in range(2):
        G.init_next_stage()
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    real, _, _ = fast.data(pyr, 3, 2, 64)
    z = _x((fast.BATCH, *pyr.shape3d(0), 3), 65)
    metrics = steps.baseline_step(
        G, D, optim.build_g_optimizer(cfg, G, 2),
        optim.build_d_optimizer(cfg, D), cfg, real, z, z, fast.AMPS[:3],
        generator=torch.Generator().manual_seed(66))
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_a_sharded_packed_step_matches_one_process(tmp_path):
    """A packed GAN step (every stage and the critic at ``WPACK_MIN_W``
    8; the packed convs' H halo and the packed BatchNorm's mesh
    statistics) over 1x2 and 2x1 gloo ranks against one process: the
    critic's metrics and every gradient that reaches Adam at the f32 bar,
    the parameters after the step within ``2 * lr``."""
    cfg = fast.cfg_of(Config, wpack=True)
    cfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(61))
    real, real_zero, noise_init = fast.data(pyr, 3, SCALE, 62)
    draws = torch.Generator().manual_seed(63)
    case = dict(cfg={**fast.TINY, "wpack": True}, ar=0.5625, org_fps=24.0,
                scale=SCALE, stages=SCALE, step="gan", G=G.state_dict(),
                D=D.state_dict(), data=(real, real_zero, noise_init),
                amps=fast.AMPS, noises=G.draw_stage_noises(fast.BATCH, draws),
                eps=G.draw_eps(real_zero.shape, draws), alpha=0.37,
                latents=None, wpack_min_w=8)
    torch.save({"case": case}, tmp_path / "models.pt")
    procs = ranks.start_ranks("models", 2, tmp_path)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(packed, "WPACK_MIN_W", 8)
            one = ranks.run_model_case(case)
    finally:
        ranks.wait_ranks(procs)
    lr = max(g["lr"] for g in optim.build_g_optimizer(
        cfg, G, SCALE).param_groups)
    for shape in ranks.MESHES[2]:
        got = ranks.results("models", 2, tmp_path)[0][(shape, "case")]
        for metric in ("errD_real", "errD_fake", "gradient_penalty",
                       "rec_loss"):
            fast.close(got["metrics"][metric], one["metrics"][metric],
                       f"{shape} {metric}")
        for key in ("grads", "d_grads"):
            _close_dicts(got[key], one[key])
        for name, t in one["state"].items():
            if t.is_floating_point():
                diff = float((got["state"][name] - t).abs().max())
                assert diff <= 2 * lr * 1.01 + 2e-4, (shape, name, diff)
