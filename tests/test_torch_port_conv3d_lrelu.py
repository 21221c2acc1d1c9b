"""K3 of the port (``hpvaegan_tpu_torch/ops/kernels/conv3d.py``): the fused
conv3d + bias + LeakyReLU for any channel count.

On the CPU the wrapper runs its plain version; it is held against the JAX
package's Pallas kernel run by the Pallas interpreter (the Pallas
function's own XLA branch for T < 3), and the autograd Function's
gradients against ``jax.vjp`` of the custom-VJP ``conv3d_lrelu`` in
interpret mode, as tests/test_pallas_conv.py runs them.  The CUDA kernel
is held against the plain version by tests/test_torch_port_gpu.py and
``chip_smoke.py`` phase 3c, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d as jk3
from hpvaegan_tpu_torch.ops.kernels import conv3d as k3

# forward: test_pallas_conv.py's f32 bar for the kernel, as a max error
# below 1e-4 * max(|y|, 1); gradients: the f32 bar rtol 2e-3 / atol 2e-4
TOL = 1e-4
RTOL, ATOL = 2e-3, 2e-4


def _inputs(shape, c_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], c_out)) * 0.1).astype(
        np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    return x, w, b


def _assert_close(got, ref):
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(got - ref)))
    assert err < TOL * scale, (err, scale)


@pytest.mark.parametrize("shape,c_out", [
    ((2, 4, 8, 8, 3), 8),      # 3 -> 8: the encoder head's channel form
    ((1, 3, 7, 9, 5), 7),      # ragged channels and tiles
    ((1, 1, 5, 6, 5), 7),      # T = 1: the Pallas function's XLA branch
    ((2, 2, 6, 5, 4), 3),      # T = 2: the same branch, C_out 3
    # the channel counts where the CUDA kernel changes instance
    # (narrow_in C_in <= 4 < wide; narrow_out C_out <= 8 < the others), at
    # T 1, 2 and 3
    ((1, 1, 6, 7, 4), 9),      # narrow_in's widest input
    ((1, 2, 6, 7, 5), 9),      # wide's narrowest channels
    ((1, 3, 5, 6, 4), 8),      # narrow_out's widest output, C_in 4
    ((1, 2, 5, 6, 5), 8),      # narrow_out, C_in 5
    ((1, 1, 7, 5, 5), 9),      # wide at T = 1
    ((1, 3, 6, 5, 4), 9),      # narrow_in through the Pallas kernel
])
def test_cpu_matches_pallas_interpret(shape, c_out):
    x, w, b = _inputs(shape, c_out, seed=sum(shape) + c_out)
    ref = np.asarray(jk3.conv3d_lrelu_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    k3.counts.reset()
    got = k3.conv3d_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    assert k3.counts.plain_calls == 1 and k3.counts.launches == 0
    assert got.shape == (*shape[:4], c_out) and got.dtype == torch.float32
    _assert_close(got.numpy(), ref)


def test_h_tiled_ragged_matches_pallas_interpret(monkeypatch):
    """A small H block forces the Pallas kernel's tiling, ragged last
    block and halos (H=10, HB=4: blocks 4, 4, 2), as
    test_pallas_conv.py:85-94 does."""
    monkeypatch.setattr(jk3, "pick_h_block", lambda *a: 4)
    x, w, b = _inputs((1, 3, 10, 6, 8), 8, seed=5)
    ref = np.asarray(jk3.conv3d_lrelu_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = k3.conv3d_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    _assert_close(got.numpy(), ref)


def test_bf16_input_is_widened_to_f32():
    """A bf16 x gives the f32 result of its f32 widening."""
    x, w, b = _inputs((1, 3, 6, 5, 3), 8, seed=9)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = k3.conv3d_lrelu(xb, torch.from_numpy(w), torch.from_numpy(b))
    ref = k3.conv3d_lrelu(xb.float(), torch.from_numpy(w),
                          torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,c_out", [((2, 4, 8, 8, 8), 16),
                                         ((1, 2, 5, 7, 5), 3)])
def test_gradients_match_jax_vjp(shape, c_out, monkeypatch):
    """The Function's gradients against ``jax.vjp`` of the custom-VJP
    ``conv3d_lrelu`` with its primal in interpret mode
    (test_pallas_conv.py:55-74), for the cotangent of ``sum(tanh(y))``."""
    orig = jk3.conv3d_lrelu_pallas
    monkeypatch.setattr(jk3, "conv3d_lrelu_pallas",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    x, w, b = _inputs(shape, c_out, seed=3 + c_out)

    def loss(x, w, b):
        return jnp.sum(jnp.tanh(jk3.conv3d_lrelu(x, w, b)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    torch.tanh(k3.conv3d_lrelu(*leaves)).sum().backward()
    for t, r in zip(leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["x_rank", "w_cin", "b_shape", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w, b = torch.zeros(1, 3, 4, 4, 5), torch.zeros(3, 3, 3, 5, 7), \
        torch.zeros(7)
    if case == "x_rank":
        x = torch.zeros(3, 4, 4, 5)
    elif case == "w_cin":
        w = torch.zeros(3, 3, 3, 4, 7)
    elif case == "b_shape":
        b = torch.zeros(5)
    else:
        x = x.double()
    with pytest.raises((ValueError, NotImplementedError)):
        k3.conv3d_lrelu(x, w, b)
