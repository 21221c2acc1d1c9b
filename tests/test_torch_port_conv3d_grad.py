"""K1's gradients in the port (``hpvaegan_tpu_torch/ops/kernels/
conv3d_pack.py``): ``Conv3d64Function`` against ``jax.vjp`` of the JAX
package's ``conv3d64``, and the weight gradient's plain version against
``conv3d64_dw_pallas`` run by the Pallas interpreter.  On the CPU the
Function runs the plain versions; the CUDA kernels are held against them
by tests/test_torch_port_gpu.py on the card.

Tolerance: max error below 1e-4 * max(|ref|, 1) in f32 (test_pconv.py's
bar); only the summation order differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

TOL = 1e-4
SHAPES = [(1, 3, 8, 4, 64), (2, 4, 9, 6, 64)]


@pytest.fixture(autouse=True)
def _interpret():
    old = (jcp.INTERPRET, jcp.FORCE)
    jcp.INTERPRET = jcp.FORCE = True
    yield
    jcp.INTERPRET, jcp.FORCE = old


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


def _assert_close(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err < TOL * scale, (err, scale)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("neg_slope", [None, 0.2])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_jax_vjp(shape, neg_slope):
    """dx, dw, db of the port's Function against the JAX custom VJP
    (Pallas dx and dw in interpret mode); with a slope, through the
    LeakyReLU after it."""
    x, w, b, dy = _inputs(shape, seed=sum(shape))

    def jfn(x, w, b):
        y = jcp.conv3d64(x, w, b)
        return y if neg_slope is None else jnp.where(y >= 0, y,
                                                     neg_slope * y)

    y_ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(dy))

    xt, wt, bt = _leaves(x, w, b)
    cp.counts.reset()
    y = cp.conv3d64(xt, wt, bt, neg_slope=neg_slope)
    y.backward(torch.from_numpy(dy))
    # forward, dx (forward on flip_swap(w)) and dw: all plain on the CPU
    assert cp.counts.plain_calls == 3
    assert cp.counts.fwd_launches == cp.counts.dx_launches == 0
    _assert_close(y.detach().numpy(), y_ref)
    _assert_close(xt.grad.numpy(), dx_ref)
    _assert_close(wt.grad.numpy(), dw_ref)
    _assert_close(bt.grad.numpy(), db_ref)


def test_dw_plain_matches_pallas_interpret():
    x, _, _, dy = _inputs(SHAPES[1], seed=5)
    ref = jcp.conv3d64_dw_pallas(jnp.asarray(x), jnp.asarray(dy),
                                 interpret=True)
    cp.counts.reset()
    got = cp.conv3d64_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert cp.counts.plain_calls == 1 and cp.counts.dw_launches == 0
    assert got.shape == (3, 3, 3, 64, 64)
    _assert_close(got.numpy(), ref)


def test_flip_swap_matches_jax():
    w = _inputs(SHAPES[0], seed=1)[1]
    np.testing.assert_array_equal(cp.flip_swap(torch.from_numpy(w)).numpy(),
                                  np.asarray(jcp._flip_swap(jnp.asarray(w))))


@pytest.mark.parametrize("wanted", ["x", "w", "b"])
def test_backward_computes_only_what_is_asked(wanted):
    """``ctx.needs_input_grad`` skips dx (a frozen critic's input), dw and
    db; the plain calls count one forward plus the gradients run."""
    x, w, b, dy = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=2))
    {"x": x, "w": w, "b": b}[wanted].requires_grad_(True)
    cp.counts.reset()
    cp.conv3d64(x, w, b).backward(dy)
    assert cp.counts.plain_calls == 1 + (wanted in ("x", "w"))
    for name, t in (("x", x), ("w", w), ("b", b)):
        assert (t.grad is not None) == (name == wanted), name


def test_second_order_use_raises():
    """The WGAN-GP's double backprop must run the stock critic: a second
    derivative through the kernel's Function raises instead of giving
    silent zeros."""
    x, w, b = _leaves(*_inputs(SHAPES[0], seed=3)[:3])
    y = cp.conv3d64(x, w, b, neg_slope=0.2)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


def test_no_graph_without_gradients():
    """Sampling (no tensor asks for a gradient) bypasses the Function."""
    x, w, b, _ = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=4))
    assert cp.conv3d64(x, w, b).grad_fn is None
    with torch.no_grad():
        assert cp.conv3d64(x, w.requires_grad_(True), b).grad_fn is None


@pytest.mark.parametrize("case", ["shape", "dtype", "device_mismatch"])
def test_dw_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(1, 3, 4, 4, 64)
    dy = torch.zeros(1, 3, 4, 4, 64)
    if case == "shape":
        dy = torch.zeros(1, 3, 4, 5, 64)
    elif case == "dtype":
        x, dy = x.double(), dy.double()
    else:
        dy = torch.zeros(1, 3, 4, 4, 64, device="meta")
    with pytest.raises((ValueError, NotImplementedError)):
        cp.conv3d64_dw(x, dy)
