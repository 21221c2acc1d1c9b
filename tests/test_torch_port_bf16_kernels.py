"""The bf16 instances of K1 and K2 in the port (``--bf16``): their plain
versions, which the CPU path runs, against the JAX package's Pallas
kernels at bf16 run by the Pallas interpreter (the JAX package's own
``INTERPRET``/``FORCE`` switches, as tests/test_pconv.py and
tests/test_pfuse.py set them), and the Functions' gradients against
``jax.vjp`` of the JAX package's custom VJPs.  The CUDA kernels are held
against these plain versions by tests/test_torch_port_gpu.py on the card.

Inputs are bf16 values made from a numpy seed, handed to both sides as
the same bits (f32 arrays holding bf16 values, cast to bf16 on each side).

Tolerances, in units of bf16 rounding (one ulp is at most 2**-7 of a
value): both sides form the same bf16 x bf16 products, sum them in f32 in
another order and round once, so an output may take the neighbouring
bf16 value: 1 ulp, ``2**-7 * max(|ref|, 1)``.  K2's y and the input
gradients through two K1-dx also carry an earlier output's 1-ulp flips
into a second conv: 2 ulp.  dw and db are f32 sums of identical bf16
products: the f32 bar 1e-4, except where their input carries a flip
(K2's dw1 and db1: dz's flips) or is rounded to bf16 (K2's dw, as the JAX
package's bf16 correlation rounds it): 1 ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d_fuse as jcf
import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

ULP = 2.0 ** -7
F32_TOL = 1e-4
SHAPES = [(1, 3, 8, 4, 64), (2, 4, 9, 6, 64)]


@pytest.fixture(autouse=True)
def _interpret():
    old = (jcf.INTERPRET, jcf.FORCE, jcp.INTERPRET, jcp.FORCE)
    jcf.INTERPRET = jcf.FORCE = True
    jcp.INTERPRET = jcp.FORCE = True
    yield
    jcf.INTERPRET, jcf.FORCE, jcp.INTERPRET, jcp.FORCE = old


def _bf16_values(a) -> np.ndarray:
    """f32 array holding the bf16 rounding of ``a``."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _inputs(shape, seed):
    """x and dy with bf16 values; f32 weights and biases (the parameters
    stay f32 under --bf16)."""
    rng = np.random.default_rng(seed)

    def a(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return (_bf16_values(a(*shape, scale=0.5)), a(3, 3, 3, 64, 64, scale=0.05),
            a(64, scale=0.1), a(3, 3, 3, 64, 64, scale=0.05),
            a(64, scale=0.1), _bf16_values(a(*shape)))


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_close(got: torch.Tensor, ref, tol: float, dtype=torch.bfloat16):
    """``got`` has ``dtype`` and lies within ``tol * max(|ref|, 1)``."""
    assert got.dtype == dtype, got.dtype
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(got.detach().float().numpy() - ref)))
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("neg_slope", [None, 0.2])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_forward_plain_matches_pallas_bf16(shape, neg_slope):
    """x bf16, w and b rounded to bf16, f32 sums, bias and LeakyReLU in
    f32, y bf16 (conv3d_pack.py:190-197, 176-179)."""
    x, w, b, _, _, _ = _inputs(shape, seed=sum(shape))
    ref = jcp.conv3d64_pallas(_jbf(x), jnp.asarray(w).astype(jnp.bfloat16),
                              jnp.asarray(b), neg_slope=neg_slope,
                              interpret=True)
    assert ref.dtype == jnp.bfloat16
    cp.counts.reset()
    got = cp.conv3d64(_tbf(x), torch.from_numpy(w), torch.from_numpy(b),
                      neg_slope=neg_slope)
    assert cp.counts.plain_calls == 1 and cp.counts.fwd_bf16_launches == 0
    _assert_close(got, ref, ULP)


def test_k1_plain_rounds_weights_to_the_compute_dtype():
    """The repaired plain version: with bf16 x it rounds w and b to bf16
    before the f32 products, as the JAX package casts them; summing with
    the f32 weights instead would miss by more than one rounding."""
    x, w, b, _, _, _ = _inputs(SHAPES[0], seed=3)
    xt, wt, bt = _tbf(x), torch.from_numpy(w), torch.from_numpy(b)
    got = cp.conv3d64_plain(xt, wt, bt)
    want = cp.conv3d64_plain(xt, wt.to(torch.bfloat16), bt.to(torch.bfloat16))
    assert torch.equal(got, want)
    exact = cp.conv3d64_plain(xt.float(), wt, bt)
    assert not torch.equal(got, exact.to(torch.bfloat16))


@pytest.mark.parametrize("neg_slope", [None, 0.2])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_function_gradients_match_jax_vjp_bf16(shape, neg_slope):
    """dx (the forward on flip_swap(w), the cotangent cast to bf16,
    conv3d_pack.py:430-434) in bf16; dw (the dw kernel on bf16 x, dy) and
    db in f32.  With a slope the JAX side applies the LeakyReLU to the
    bf16 output, the port inside the kernel in f32: the same masks."""
    x, w, b, _, _, dy = _inputs(shape, seed=11 + sum(shape))

    def jfn(x, w, b):
        y = jcp.conv3d64(x, w, b)
        return y if neg_slope is None else jnp.where(
            y >= 0, y, jnp.asarray(neg_slope, y.dtype) * y)

    y_ref, vjp = jax.vjp(jfn, _jbf(x), jnp.asarray(w), jnp.asarray(b))
    dx_ref, dw_ref, db_ref = vjp(_jbf(dy))
    assert (dx_ref.dtype, dw_ref.dtype) == (jnp.bfloat16, jnp.float32)

    xt = _tbf(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    cp.counts.reset()
    y = cp.conv3d64(xt, wt, bt, neg_slope=neg_slope)
    y.backward(_tbf(dy))
    assert cp.counts.plain_calls == 3
    _assert_close(y, y_ref, ULP)
    _assert_close(xt.grad, dx_ref, ULP)
    _assert_close(wt.grad, dw_ref, F32_TOL, torch.float32)
    _assert_close(bt.grad, db_ref, F32_TOL, torch.float32)


def test_k1_dw_plain_matches_pallas_bf16():
    """conv3d64_dw_pallas with bf16 x and dy: f32 out (:307-365)."""
    x, _, _, _, _, dy = _inputs(SHAPES[1], seed=5)
    ref = jcp.conv3d64_dw_pallas(_jbf(x), _jbf(dy), interpret=True)
    assert ref.dtype == jnp.float32
    cp.counts.reset()
    got = cp.conv3d64_dw(_tbf(x), _tbf(dy))
    assert cp.counts.plain_calls == 1 and cp.counts.dw_bf16_launches == 0
    _assert_close(got, ref, F32_TOL, torch.float32)
    # an f32 dy is rounded to x's dtype first, as the JAX package casts it
    torch.testing.assert_close(
        cp.conv3d64_dw(_tbf(x), torch.from_numpy(dy) * 1.001),
        cp.conv3d64_dw(_tbf(x), (torch.from_numpy(dy) * 1.001).to(
            torch.bfloat16)), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_pallas_bf16(shape):
    """The z ring holds bf16 (conv3d_fuse.py:173, 282): conv2 reads the
    rounded z.  y and z bf16."""
    x, w1, b1, w2, b2, _ = _inputs(shape, seed=21 + sum(shape))
    y_ref, z_ref = jcf.conv3d64_pair_pallas(
        _jbf(x), jnp.asarray(w1).astype(jnp.bfloat16), jnp.asarray(b1),
        jnp.asarray(w2).astype(jnp.bfloat16), jnp.asarray(b2),
        with_mid=True, interpret=True)
    assert y_ref.dtype == z_ref.dtype == jnp.bfloat16
    cf.counts.reset()
    y, z = cf.conv3d64_pair_forward(_tbf(x), *map(torch.from_numpy,
                                                  (w1, b1, w2, b2)),
                                    with_mid=True)
    assert cf.counts.plain_calls == 1 and cf.counts.bf16_launches == 0
    _assert_close(z, z_ref, ULP)
    _assert_close(y, y_ref, 2 * ULP)
    # conv2 reads the rounded z: the plain pair is two rounded convs
    torch.testing.assert_close(
        y, cp.conv3d64_plain(z, torch.from_numpy(w2), torch.from_numpy(b2),
                             neg_slope=cf.SLOPE), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_function_gradients_match_jax_vjp_bf16(shape):
    """The pair's backward (conv3d_fuse.py:315-342) in bf16: dx bf16 after
    two K1-dx, dw1/dw2 rounded to bf16 as the JAX package's bf16
    correlation gives them, db1/db2 f32 sums."""
    x, w1, b1, w2, b2, dy = _inputs(shape, seed=31 + sum(shape))
    y_ref, vjp = jax.vjp(jcf.conv3d64_pair, _jbf(x),
                         *map(jnp.asarray, (w1, b1, w2, b2)))
    refs = vjp(_jbf(dy))
    assert [r.dtype for r in refs] == [jnp.bfloat16] + [jnp.float32] * 4

    leaves = [_tbf(x).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in (w1, b1, w2, b2)]
    cf.counts.reset()
    cp.counts.reset()
    y = cf.conv3d64_pair(*leaves)
    y.backward(_tbf(dy))
    assert cf.counts.plain_calls == 1 and cp.counts.plain_calls == 4
    _assert_close(y, y_ref, 2 * ULP)
    tols = (2 * ULP, ULP, ULP, ULP, F32_TOL)
    dtypes = (torch.bfloat16,) + (torch.float32,) * 4
    for leaf, ref, tol, dtype in zip(leaves, refs, tols, dtypes):
        _assert_close(leaf.grad, ref, tol, dtype)


@pytest.mark.parametrize("case", ["float16_x", "f64_weight"])
def test_bf16_wrappers_reject_other_dtypes(case):
    x = dy = torch.zeros(1, 3, 4, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 64, 64)
    if case == "float16_x":
        x = x.half()
    else:
        w, dy = w.double(), dy.double()
    b = w[0, 0, 0, 0]
    for call in (lambda: cp.conv3d64(x, w), lambda: cp.conv3d64_dw(x, dy),
                 lambda: cf.conv3d64_pair(x, w, b, w, b)):
        with pytest.raises(NotImplementedError):
            call()
