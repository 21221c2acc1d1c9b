"""The port's numpy copy of JAX's and flax's draws
(``hpvaegan_tpu_torch/eval/jax_init.py``) against ``jax.random`` and the
JAX package's random eval trunks.

Tolerance: none.  Every key, bit and float is held bit for bit, the whole
random C3D to ``conv3b`` and the Inception stem to ``pool1`` included
(``random_c3d_params`` / ``random_stem_params`` at seeds 0 and 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from hpvaegan_tpu.eval.c3d import random_c3d_params as j_random_c3d
from hpvaegan_tpu.eval._sifid import random_stem_params as j_random_stem
from hpvaegan_tpu_torch.eval import jax_init
from hpvaegan_tpu_torch.eval.c3d import random_c3d_params
from hpvaegan_tpu_torch.eval._sifid import random_stem_params

SHAPES = [(1,), (7,), (8,), (3, 5, 2), (2, 3, 3, 3, 4), (1001,)]
SEEDS = [0, 3, 12345]


def _key(seed, data=None):
    key = jax.random.PRNGKey(seed)
    return key if data is None else jax.random.fold_in(key, data)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS + [2**31 - 1])
def test_prng_key_and_fold_in(seed):
    assert (np.asarray(_key(seed)) == jax_init.prng_key(seed)).all()
    for data in (0, 1, 987654321, 2**32 - 1):
        got = jax_init.fold_in(jax_init.prng_key(seed), data)
        assert (np.asarray(_key(seed, data)) == got).all(), data


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_truncated_normal(seed, shape):
    key = _key(seed, 77)
    k = np.asarray(key)
    assert (np.asarray(jax.random.bits(key, shape, jnp.uint32))
            == jax_init.random_bits(k, shape)).all()
    for lo, hi in ((0.0, 1.0), (-0.3, 1.7), (float(jax_init.ERF_LO),
                                              float(jax_init.ERF_HI))):
        want = jax.random.uniform(key, shape, jnp.float32, lo, hi)
        assert (_bits(want) == _bits(jax_init.uniform(k, shape, lo, hi))
                ).all(), (lo, hi)
    want = jax.random.truncated_normal(key, -2, 2, shape, jnp.float32)
    assert (_bits(want) == _bits(jax_init.truncated_normal(k, shape))).all()


def test_threefry_counts_of_odd_and_even_sizes():
    """An odd count is padded by one word in ``threefry_2x32``; the
    partitionable layout hashes each element's own counter pair."""
    k = jax_init.prng_key(5)
    for n in (1, 2, 3, 4, 9):
        bits = jax_init.random_bits(k, (n,))
        assert bits.shape == (n,) and bits.dtype == np.uint32
        assert (jax_init.random_bits(k, (n + 1,))[:n] == bits).all()


def test_erf_constants_are_xlas():
    s2 = np.array(np.sqrt(2), np.float32)
    lo = lax.erf(jnp.float32(-2.0) / s2)
    hi = lax.erf(jnp.float32(2.0) / s2)
    assert _bits(lo) == _bits(jax_init.ERF_LO)
    assert _bits(hi) == _bits(jax_init.ERF_HI)


def test_erf_inv_equals_xla_on_200k_points():
    x = np.random.default_rng(0).uniform(
        jax_init.ERF_LO, jax_init.ERF_HI, 200_000).astype(np.float32)
    x[:4] = [0.0, -0.0, jax_init.ERF_LO, jax_init.ERF_HI]
    want = jax.jit(lax.erf_inv)(x)
    assert (_bits(want) == _bits(jax_init.erf_inv(x))).all()


@pytest.mark.parametrize("shape", [(3, 3, 3, 3, 64), (3, 3, 32, 64),
                                   (5, 7)])
def test_lecun_normal(shape):
    key = _key(9, 4)
    want = jax.nn.initializers.lecun_normal()(key, shape, jnp.float32)
    got = jax_init.lecun_normal(np.asarray(key), shape)
    assert (_bits(want) == _bits(got)).all()


@pytest.mark.parametrize("name", ["conv1", "Conv2d_2b_3x3", "x"])
def test_flax_param_key(name):
    """flax's first ``params`` key in a top-level submodule: an init
    that only draws one normal under ``self.param`` sees it."""
    import flax.linen as nn

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return self.param(
                "w", lambda k: jax.random.bits(k, (4,), jnp.uint32))

    class Top(nn.Module):
        @nn.compact
        def __call__(self):
            return Probe(name=name)()

    params = Top().init(jax.random.PRNGKey(3))["params"]
    want = np.asarray(params[name]["w"])
    got = jax_init.random_bits(
        jax_init.flax_param_key(jax_init.prng_key(3), name), (4,))
    assert (want == got).all()


def _assert_trees_bit_equal(got, want):
    want = want["params"]
    assert sorted(got["params"]) == sorted(want)
    for name, p in want.items():
        for leaf in ("kernel", "bias"):
            a, b = got["params"][name][leaf], np.asarray(p[leaf])
            assert a.shape == b.shape and a.dtype == np.float32, name
            assert (_bits(a) == _bits(b)).all(), (name, leaf)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_c3d_trunk_to_conv3b_is_the_jax_trunk(seed):
    _assert_trees_bit_equal(random_c3d_params("conv3b", seed),
                            j_random_c3d("conv3b", seed))


@pytest.mark.parametrize("layer", ["conv1", "conv2"])
def test_random_c3d_early_taps_build_only_their_layers(layer):
    _assert_trees_bit_equal(random_c3d_params(layer, 1),
                            j_random_c3d(layer, 1))


@pytest.mark.parametrize("tap", ["Conv2d_1a_3x3", "Conv2d_2a_3x3",
                                 "Conv2d_2b_3x3", "pool1"])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_stem_is_the_jax_stem(tap, seed):
    _assert_trees_bit_equal(random_stem_params(tap, seed),
                            j_random_stem(tap, seed))


def test_unknown_layers_raise():
    with pytest.raises(ValueError, match="unknown C3D layer"):
        random_c3d_params("fc6")
    with pytest.raises(ValueError, match="unknown SIFID tap"):
        random_stem_params("Mixed_5b")
