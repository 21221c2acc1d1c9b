"""K2 of the port (``hpvaegan_tpu_torch/ops/kernels/conv3d_fuse.py``): its
plain version (y and z) against ``conv3d64_pair_pallas(with_mid=True)``
run by the Pallas interpreter, and ``Conv3d64PairFunction``'s gradients
against ``jax.vjp`` of the JAX package's ``conv3d64_pair``, with the JAX
package's own ``INTERPRET``/``FORCE`` switches (as tests/test_pfuse.py
sets them) at shapes its gates accept (T >= 3, even W, H >= 8).  The CUDA
kernel is held against the plain version by tests/test_torch_port_gpu.py.

Tolerance: max error below 1e-4 * max(|ref|, 1) in f32; only the
summation order differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d_fuse as jcf
import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

TOL = 1e-4
SHAPES = [(1, 3, 8, 4, 64), (2, 4, 9, 6, 64)]


@pytest.fixture(autouse=True)
def _interpret():
    old = (jcf.INTERPRET, jcf.FORCE, jcp.INTERPRET, jcp.FORCE)
    jcf.INTERPRET = jcf.FORCE = True
    jcp.INTERPRET = jcp.FORCE = True  # the VJP runs the packed dx kernel
    yield
    jcf.INTERPRET, jcf.FORCE, jcp.INTERPRET, jcp.FORCE = old


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)

    def a(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return (a(*shape, scale=0.5), a(3, 3, 3, 64, 64, scale=0.05),
            a(64, scale=0.1), a(3, 3, 3, 64, 64, scale=0.05),
            a(64, scale=0.1), a(*shape))


def _assert_close(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err < TOL * scale, (err, scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_with_mid(shape):
    """(2,4,9,6,64): H=9 leaves a ragged H block in the Pallas kernel;
    the z edges must be zero (conv2's SAME padding), not lrelu(b1)."""
    x, w1, b1, w2, b2, _ = _inputs(shape, seed=sum(shape))
    y_ref, z_ref = jcf.conv3d64_pair_pallas(
        *map(jnp.asarray, (x, w1, b1, w2, b2)), with_mid=True,
        interpret=True)
    cf.counts.reset()
    y, z = cf.conv3d64_pair_forward(*map(torch.from_numpy,
                                         (x, w1, b1, w2, b2)), with_mid=True)
    assert cf.counts.plain_calls == 1 and cf.counts.launches == 0
    _assert_close(y.numpy(), y_ref)
    _assert_close(z.numpy(), z_ref)
    # without with_mid: y alone, the same values
    y2 = cf.conv3d64_pair(*map(torch.from_numpy, (x, w1, b1, w2, b2)))
    np.testing.assert_array_equal(y2.numpy(), y.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_jax_vjp(shape):
    x, w1, b1, w2, b2, dy = _inputs(shape, seed=7 + sum(shape))
    y_ref, vjp = jax.vjp(jcf.conv3d64_pair,
                         *map(jnp.asarray, (x, w1, b1, w2, b2)))
    refs = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w1, b1, w2, b2)]
    cf.counts.reset()
    cp.counts.reset()
    y = cf.conv3d64_pair(*leaves)
    y.backward(torch.from_numpy(dy))
    # the fused forward, then dz, dx (plain forward on flip_swap) and
    # dw2, dw1 (plain dw): all on the CPU
    assert cf.counts.plain_calls == 1
    assert cp.counts.plain_calls == 4
    _assert_close(y.detach().numpy(), y_ref)
    for leaf, ref in zip(leaves, refs):
        _assert_close(leaf.grad.numpy(), ref)


def test_frozen_weights_skip_the_weight_gradients():
    """The generator step runs the critic with its parameters frozen:
    only dz and dx run, no dw."""
    x, w1, b1, w2, b2, dy = map(torch.from_numpy, _inputs(SHAPES[0], seed=3))
    x.requires_grad_(True)
    cp.counts.reset()
    cf.conv3d64_pair(x, w1, b1, w2, b2).backward(dy)
    assert cp.counts.plain_calls == 2
    assert x.grad is not None and w1.grad is None and b2.grad is None


def test_second_order_use_raises():
    x, w1, b1, w2, b2, _ = map(torch.from_numpy, _inputs(SHAPES[0], seed=4))
    x.requires_grad_(True)
    y = cf.conv3d64_pair(x, w1, b1, w2, b2)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


@pytest.mark.parametrize("case", ["no_bias", "w_shape", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w1, b1, w2, b2, _ = map(torch.from_numpy, _inputs(SHAPES[0], seed=5))
    if case == "no_bias":
        b2 = None
    elif case == "w_shape":
        w2 = torch.zeros(3, 3, 3, 64, 32)
    else:
        x = x.double()
    with pytest.raises((ValueError, NotImplementedError)):
        cf.conv3d64_pair(x, w1, b1, w2, b2)
