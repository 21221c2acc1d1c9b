"""K1's gradients in the port (``hpvaegan_tpu_torch/ops/kernels/
conv3d_pack.py``): ``Conv3d64Function`` against ``jax.vjp`` of the JAX
package's ``conv3d64``, and the weight gradient's plain version against
``conv3d64_dw_pallas`` run by the Pallas interpreter.  Second order: a
WGAN-GP-style penalty through the Function (its gradients w.r.t. x, w
and b) against the same through JAX's ``conv3d64`` (three cases, Pallas
in interpret mode) and through the lax composition, JAX's own reference
formulation (``tests/test_pconv.py:_xla``); ``Conv3d64DwFunction``'s
backward against ``jax.vjp`` of ``_dw``.  On the CPU the Functions run
the plain versions; the CUDA kernels are held against them by
tests/test_torch_port_gpu.py on the card.

Tolerance: max error below 1e-4 * max(|ref|, 1) in f32 (test_pconv.py's
bar; only the summation order differs), 5e-2 * max(|ref|, 1) in bf16
(test_pconv.py's bf16 bar: the two sides round their bf16 convs at other
points)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import penalty_grads  # noqa: E402  (phase 17's scalar)

TOL = 1e-4
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
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


def _assert_close(got, ref, tol=TOL):
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(np.asarray(got, dtype=np.float32) - ref)))
    assert err < tol * scale, (err, scale)


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


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


def _xla(x, w, b):
    """The lax composition of ``tests/test_pconv.py:_xla``."""
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NTHWC", "THWIO", "NTHWC"))
    return jax.lax.conv_general_dilated(
        x, w.astype(x.dtype), (1, 1, 1), "SAME",
        dimension_numbers=dn) + b.astype(x.dtype)


def _jax_penalty_grads(conv, x, w, b, neg_slope):
    """d/d(x, w, b) of ``sum_voxels (|grad_x sum tanh(f(x))|_channels -
    1)^2``, f = ``conv`` then LeakyReLU: the WGAN-GP's shape."""
    def f(x, w, b):
        y = conv(x, w, b)
        return y if neg_slope is None else jax.nn.leaky_relu(y, neg_slope)

    def penalty(x, w, b):
        g = jax.grad(lambda xx: jnp.sum(jnp.tanh(
            f(xx, w, b).astype(jnp.float32))))(x).astype(jnp.float32)
        return jnp.sum((jnp.sqrt(jnp.sum(g * g, axis=-1)) - 1.0) ** 2)

    return jax.jit(jax.grad(penalty, (0, 1, 2)))(x, w, b)


def _port_penalty_grads(x, w, b, neg_slope):
    """The same through the port's ``conv3d64``."""
    leaves = tuple(t.requires_grad_(True) for t in (x, w, b))
    return penalty_grads(
        lambda x, w, b: cp.conv3d64(x, w, b, neg_slope=neg_slope), *leaves,
        leaves)


def _second_order_inputs(dtype):
    x, w, b, _ = _inputs(SHAPES[0], seed=3)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, jnp.asarray(w), jnp.asarray(b)), (tx, torch.from_numpy(w),
                                                   torch.from_numpy(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("neg_slope", [None, 0.2])
def test_second_order_matches_the_lax_composition(dtype, neg_slope):
    """The penalty's gradients through the Function (forward, the inner
    dx; then the outer dx and dw of both nodes: six plain calls, no dw in
    the inner pass) against JAX's reference formulation; x's gradient in
    x's dtype, w's and b's in f32."""
    jargs, targs = _second_order_inputs(dtype)
    refs = _jax_penalty_grads(_xla, *jargs, neg_slope)
    cp.counts.reset()
    got = _port_penalty_grads(*targs, neg_slope)
    assert cp.counts.plain_calls == 6
    assert [t.dtype for t in got] == [targs[0].dtype, torch.float32,
                                      torch.float32]
    for g, r in zip(got, refs):
        _assert_close(_np32(g), r, TOLS[dtype])


@pytest.mark.parametrize("dtype,neg_slope", [("float32", None),
                                             ("float32", 0.2),
                                             ("bfloat16", 0.2)])
def test_second_order_matches_the_pallas_rule(dtype, neg_slope):
    """The same against JAX's ``conv3d64`` (Pallas in interpret mode),
    whose backward re-enters itself and whose dw is the ``custom_jvp``
    ``_dw``: the rule the port's Functions copy."""
    jargs, targs = _second_order_inputs(dtype)
    refs = _jax_penalty_grads(jcp.conv3d64, *jargs, neg_slope)
    for g, r in zip(_port_penalty_grads(*targs, neg_slope), refs):
        _assert_close(_np32(g), r, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_function_backward_matches_jax_vjp(dtype):
    """``Conv3d64DwFunction``'s backward (grad x: K1 on ``flip_swap(g)``,
    grad dy: K1 on g) against ``jax.vjp`` of JAX's ``_dw``, whose
    transpose is the XLA correlation; the forward too (Pallas dw in
    interpret mode)."""
    x, w, _, dy = _inputs(SHAPES[1], seed=6)
    jx, jdy = (jnp.asarray(a).astype(dtype) for a in (x, dy))
    dw_ref, vjp = jax.vjp(jcp._dw, jx, jdy)
    gx_ref, gdy_ref = vjp(jnp.asarray(w))
    xt, dyt = (torch.from_numpy(a).to(getattr(torch, dtype))
               .requires_grad_(True) for a in (x, dy))
    cp.counts.reset()
    dw = cp.Conv3d64DwFunction.apply(xt, dyt)
    gx, gdy = torch.autograd.grad(dw, (xt, dyt), torch.from_numpy(w))
    assert cp.counts.plain_calls == 3
    assert dw.dtype == torch.float32
    assert gx.dtype == gdy.dtype == getattr(torch, dtype)
    # dw: f32 sums of the same bf16 products
    _assert_close(_np32(dw), dw_ref)
    for g, r in ((gx, gx_ref), (gdy, gdy_ref)):
        _assert_close(_np32(g), r, TOLS[dtype])


def test_input_grads_only_skips_dw_and_db():
    """A gradient taken w.r.t. the input alone runs dx alone, though
    ``ctx.needs_input_grad`` asks for all three (the backward asks the
    autograd engine which edges it will run); w.r.t. all three, all
    three again."""
    x, w, b, dy = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=2))
    leaves = [t.requires_grad_(True) for t in (x, w, b)]
    cp.counts.reset()
    y = cp.conv3d64(*leaves)
    (gx,) = torch.autograd.grad(y, leaves[0], dy)
    assert cp.counts.plain_calls == 2
    assert w.grad is None and b.grad is None
    cp.counts.reset()
    grads = torch.autograd.grad(cp.conv3d64(*leaves), leaves, dy)
    assert cp.counts.plain_calls == 3
    torch.testing.assert_close(grads[0], gx, rtol=0, atol=0)


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
