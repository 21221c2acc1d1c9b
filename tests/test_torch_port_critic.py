"""The port's critic and losses against the JAX package: ``WDiscriminator``
(num_layer 3 under pconv + pfuse: one K2 pair and one K1 block, their
plain versions on the CPU), ``SNConv.spectral_update``,
``load_discriminator``, the parameter gradients through the kernels'
Functions, and the losses with the WGAN-GP on an injected alpha.  The JAX
critic runs its lax path; its variable tree is the same by construction.

Tolerance: f32 rtol 2e-3 / atol 2e-4 (tests/test_torch_parity.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.losses import (calc_gradient_penalty as j_gp,
                                 kl_bern_criterion as j_kl_bern,
                                 kl_criterion as j_kl, mse as j_mse)
from hpvaegan_tpu.models.blocks import spectral_update as j_spectral_update
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu_torch import losses
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.generators import (to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_discriminator
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.utils import convert

RTOL, ATOL = 2e-3, 2e-4
SHAPE = (2, 4, 8, 6, 3)
NUM_LAYER = 3


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def critics():
    jD = JCritic(nfc=64, ker_size=3, num_layer=NUM_LAYER, ndim=3)
    dvars = _np(jax.jit(jD.init)(jax.random.PRNGKey(0), jnp.zeros(SHAPE)))
    # advance u/v once, so the loaded state is not the init state
    dvars["spectral"] = _np(jax.jit(j_spectral_update)(dvars["params"],
                                                       dvars["spectral"]))
    D = WDiscriminator(3, 64, 3, NUM_LAYER, ndim=3, pconv=True, pfuse=True)
    convert.load_discriminator(D, dvars)
    return jD, dvars, D


def _x(shape=SHAPE, seed=0):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)
                   ).astype(np.float32)


def _grad_to_flax(g: torch.Tensor) -> np.ndarray:
    """torch (O, I, *k) -> flax (*k, I, O)."""
    return np.moveaxis(np.moveaxis(g.numpy(), 0, -1), 0, -2)


def test_routes_one_pair_and_one_block(critics):
    _, _, D = critics
    assert D.pfuse and [b.kernel_route for b in D.body] == [True] * 3
    assert not D.head.kernel_route and not D.tail.kernel_route


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_jax(critics, use_kernels):
    jD, dvars, D = critics
    x = _x()
    ref = jax.jit(jD.apply)(dvars, x)
    cp.counts.reset()
    cf.counts.reset()
    with torch.no_grad():
        out = to_public_layout(D(to_model_layout(x), use_kernels)).numpy()
    assert out.shape == (*SHAPE[:-1], 1)
    assert cf.counts.plain_calls == int(use_kernels)
    assert cp.counts.plain_calls == int(use_kernels)
    _close(out, ref)


def test_parameter_gradients_through_the_kernels_match_jax(critics):
    """sigma stays differentiable; K2's and K1's Functions give the JAX
    gradients of every kernel and bias."""
    jD, dvars, D = critics
    x = _x(seed=1)
    grads = _np(jax.jit(jax.grad(
        lambda p: jnp.mean(jD.apply({**dvars, "params": p}, x) ** 2)))(
            dvars["params"]))
    D.zero_grad(set_to_none=True)
    D(to_model_layout(x)).square().mean().backward()
    for name, m in [("head", D.head)] + [(f"block{i}", b)
                                         for i, b in enumerate(D.body)]:
        _close(_grad_to_flax(m.weight.grad), grads[name]["kernel"])
        _close(m.bias.grad.numpy(), grads[name]["bias"])
    _close(_grad_to_flax(D.tail.weight.grad), grads["tail"]["conv"]["kernel"])


def test_spectral_update_matches_jax(critics):
    _, dvars, _ = critics
    new = _np(jax.jit(j_spectral_update)(dvars["params"], dvars["spectral"]))
    D = WDiscriminator(3, 64, 3, NUM_LAYER, ndim=3)
    convert.load_discriminator(D, dvars)
    for m in D.sn_convs():
        m.spectral_update()
    ref = WDiscriminator(3, 64, 3, NUM_LAYER, ndim=3)
    convert.load_discriminator(ref, {**dvars, "spectral": new})
    for got, want in zip(D.sn_convs(), ref.sn_convs()):
        _close(got.u.numpy(), want.u.numpy(), rtol=1e-5, atol=1e-6)
        _close(got.v.numpy(), want.v.numpy(), rtol=1e-5, atol=1e-6)


def test_load_discriminator_copies_every_variable(critics):
    _, dvars, D = critics
    np.testing.assert_array_equal(D.head.u.numpy(),
                                  dvars["spectral"]["head"]["u"])
    np.testing.assert_array_equal(D.tail.bias.detach().numpy(),
                                  dvars["params"]["tail"]["conv"]["bias"])
    np.testing.assert_array_equal(
        _grad_to_flax(D.body[2].weight.detach()),
        dvars["params"]["block2"]["kernel"])


def test_gradient_penalty_with_injected_alpha_matches_jax(critics):
    """One scalar alpha for the batch, the norm over the channel axis only;
    the penalty and its gradients in the critic's parameters."""
    jD, dvars, D = critics
    real, fake = _x(seed=2), _x(seed=3)
    key = jax.random.PRNGKey(9)
    alpha = float(jax.random.uniform(key, ()))

    def jgp(params):
        return j_gp(lambda x: jD.apply({**dvars, "params": params}, x),
                    jnp.asarray(real), jnp.asarray(fake), 0.1, key)

    ref, ref_grads = jax.jit(jax.value_and_grad(jgp))(dvars["params"])
    D.zero_grad(set_to_none=True)
    gp = losses.calc_gradient_penalty(
        lambda x: D(x, use_kernels=False), to_model_layout(real),
        to_model_layout(fake), 0.1, alpha=torch.tensor(alpha))
    gp.backward()
    _close(gp.item(), float(ref))
    _close(_grad_to_flax(D.body[0].weight.grad),
           np.asarray(ref_grads["block0"]["kernel"]))
    _close(D.head.bias.grad.numpy(), np.asarray(ref_grads["head"]["bias"]))


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    mu, logvar, a, b = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
                        for _ in range(4))
    p = rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)
    t = torch.from_numpy
    _close(losses.kl_criterion(t(mu), t(logvar)).item(),
           float(j_kl(mu, logvar)))
    _close(losses.kl_bern_criterion(t(p)).item(), float(j_kl_bern(p)))
    _close(losses.mse(t(a), t(b)).item(), float(j_mse(a, b)))


def test_make_discriminator_routes():
    cfg = Config(pconv_all=True, pfuse=True)
    D = make_discriminator("WDiscriminator3D", cfg, ndim=3)
    assert D.pfuse and all(b.kernel_route for b in D.body)
    plain = make_discriminator("WDiscriminator3D", Config(), ndim=3)
    assert not plain.pfuse and not any(b.kernel_route for b in plain.body)
    with pytest.raises(ValueError):
        make_discriminator("WDiscriminator2D", cfg, ndim=3)
    # the baselines' BatchNorm critic has no kernel route, whatever the
    # routing flags say (as in the JAX package)
    base = make_discriminator("WDiscriminatorBaselines", cfg, ndim=3)
    assert not base.sn_convs() and not hasattr(base, "pfuse")
    assert not any(getattr(m, "kernel_route", False)
                   for m in base.modules())
    assert [b.norm is not None for b in (base.head, *base.body)] == \
        [False] + [True] * cfg.num_layer
