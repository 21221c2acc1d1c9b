"""K4, the K1 conv over a (data, spatial) mesh (``hpvaegan_tpu_torch/ops/
kernels/conv3d_spmd.py``), on groups of 2 and 4 gloo CPU ranks against
the JAX package's ``conv3d64_spmd`` (Pallas in interpret mode, as
tests/test_pconv_spmd.py:27-33 runs it) on the same meshes of virtual
devices: y, dx, dw and db of ``sum(y * cos(y))``, dw and db summed over
the ranks (K4 sums nothing itself).  Where the JAX gate refuses a shape
(H that the spatial axis does not divide), the port is held against
JAX's lax conv, as tests/test_pconv_spmd.py:70-101 does.  Also the halo
exchange: its adjoint in float64 and a double-backward check through a
haloed stock conv.  Tolerance: the f32 default, rtol 2e-3 / atol 2e-4.
K4's second order (a WGAN-GP-style penalty through ``conv3d64_spmd``)
on every mesh against JAX's ``conv3d64_spmd`` on the 1x2 virtual mesh:
its gradients w.r.t. the whole x, w and b, at 1e-4 * max(|ref|, 1)
(test_pconv.py's f32 bar).

The ranks run once per module (``torch_port_ranks.py``), each a fresh
interpreter that imports torch and the port only."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu.ops.pallas.conv3d_spmd import conv3d64_spmd, pconv_spmd_ok
from hpvaegan_tpu.parallel import make_mesh
from torch_port_ranks import MESHES, results, start_ranks, wait_ranks

RTOL, ATOL = 2e-3, 2e-4
GP_TOL = 1e-4
PROGRAMS = "k4,halo,k4gp"
# H = 16 splits evenly over 2 spatial ranks; H = 15 does not (T >= 3 and
# an even W for the JAX kernel's own gate)
SHAPES = {"even": (2, 3, 16, 8, 64), "uneven": (2, 3, 15, 8, 64)}
CASES = [(shape, name, fn) for world in (2, 4) for shape in MESHES[world]
         for name in SHAPES for fn in ("conv3d64_spmd",
                                       "conv3d64_spmd_plain")]


def _inputs(name):
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal(SHAPES[name]) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, w, b


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank groups (2 and 4), started together, their results by
    world."""
    d = tmp_path_factory.mktemp("k4")
    torch.save({"k4": {n: tuple(torch.from_numpy(a) for a in _inputs(n))
                       for n in SHAPES},
                "k4gp": tuple(torch.from_numpy(a)
                              for a in _inputs("even"))}, d / "inputs.pt")
    groups = {w: start_ranks(PROGRAMS, w, d) for w in (2, 4)}
    for procs in groups.values():
        wait_ranks(procs)
    return {w: results(PROGRAMS, w, d) for w in groups}


def _xla(x, w, b):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NTHWC", "THWIO", "NTHWC"))
    return jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=dn) + b


@functools.lru_cache(maxsize=None)
def _jax_reference(mesh_shape, name):
    """y, dx, dw, db from JAX: its K4 where its gate takes the shape, else
    the lax conv; and which of the two ran."""
    x, w, b = _inputs(name)
    mesh = make_mesh(mesh_shape)
    use_k4 = pconv_spmd_ok(x.shape, w.shape, mesh)
    old = jcp.INTERPRET, jcp.FORCE
    jcp.INTERPRET = jcp.FORCE = True
    try:
        if use_k4:
            xs = jax.device_put(x, NamedSharding(
                mesh, P("data", None, "spatial", None, None)))

            def conv(x, w, b):
                return conv3d64_spmd(x, w, b, mesh)
        else:
            xs, conv = x, _xla

        def loss(x, w, b):
            y = conv(x, w, b)
            return jnp.sum(y * jnp.cos(y)), y

        (_, y), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(xs, w, b)
        return [np.asarray(a) for a in (y, *grads)], use_k4
    finally:
        jcp.INTERPRET, jcp.FORCE = old


@pytest.mark.parametrize("mesh_shape,name,fn", CASES)
def test_k4_matches_jax(ranks, mesh_shape, name, fn):
    world = mesh_shape[0] * mesh_shape[1]
    outs = [r[(mesh_shape, name, fn)] for r in ranks[world]]
    (y_ref, dx_ref, dw_ref, db_ref), use_k4 = _jax_reference(mesh_shape,
                                                            name)
    # an H that the spatial axis does not divide runs the lax conv in
    # JAX, K4 in the port
    assert use_k4 == (name == "even" or mesh_shape[1] == 1)
    y, dx = np.zeros_like(y_ref), np.zeros_like(dx_ref)
    for o in outs:
        (b0, b1), (h0, h1) = o["rows"], o["block"]
        y[b0:b1, :, h0:h1] = o["y"].numpy()
        dx[b0:b1, :, h0:h1] = o["dx"].numpy()
        # every rank ran K1 (here its plain version) once, through K4
        assert o["plain_calls"] == (1 if fn == "conv3d64_spmd" else 0)
    dw = sum(o["dw"].numpy() for o in outs)
    db = sum(o["db"].numpy() for o in outs)
    for what, got, ref in (("y", y, y_ref), ("dx", dx, dx_ref),
                           ("dw", dw, dw_ref), ("db", db, db_ref)):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("mesh_shape,h", [((1, 2), 7), ((1, 2), 9),
                                          ((2, 2), 7), ((2, 2), 9)])
def test_halo_is_adjoint_to_its_backward(ranks, mesh_shape, h):
    """<E x, y> = <x, E^T y> over the whole mesh, in float64: the
    backward returns each halo row's cotangent to its sender."""
    world = mesh_shape[0] * mesh_shape[1]
    for r in ranks[world]:
        ex_y, x_ety = r[(mesh_shape, h, "adjoint")].tolist()
        assert abs(ex_y - x_ety) <= 1e-12 * max(1.0, abs(ex_y)), (ex_y,
                                                                  x_ety)


@pytest.mark.parametrize("mesh_shape,live", [((1, 2), 0), ((1, 2), 1),
                                             ((2, 2), 0), ((2, 2), 1)])
def test_haloed_stock_conv_passes_gradgradcheck(ranks, mesh_shape, live):
    """The WGAN-GP backpropagates twice through the stock critic's haloed
    convs: ``gradgradcheck`` on every rank, with ``live``'s output the
    one that counts."""
    world = mesh_shape[0] * mesh_shape[1]
    assert all(r[(mesh_shape, "gradgradcheck", live)] is True
               for r in ranks[world])


@functools.lru_cache(maxsize=None)
def _jax_second_order():
    """dx, dw, db of the WGAN-GP-style penalty through JAX's K4 on the 1x2
    virtual mesh (Pallas in interpret mode), on the whole tensors."""
    x, w, b = _inputs("even")
    mesh = make_mesh((1, 2))
    assert pconv_spmd_ok(x.shape, w.shape, mesh)
    old = jcp.INTERPRET, jcp.FORCE
    jcp.INTERPRET = jcp.FORCE = True
    try:
        xs = jax.device_put(x, NamedSharding(
            mesh, P("data", None, "spatial", None, None)))

        def penalty(x, w, b):
            g = jax.grad(lambda xx: jnp.sum(jnp.tanh(
                conv3d64_spmd(xx, w, b, mesh))))(x)
            return jnp.sum((jnp.sqrt(jnp.sum(g * g, axis=-1)) - 1.0) ** 2)

        grads = jax.jit(jax.grad(penalty, (0, 1, 2)))(xs, w, b)
        return [np.asarray(a) for a in grads]
    finally:
        jcp.INTERPRET, jcp.FORCE = old


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2)])
def test_k4_second_order_matches_jax(ranks, mesh_shape):
    """Each rank's dx block, and dw and db summed over the ranks; every
    rank ran K4 once and K1 six times (forward, inner dx, then the outer
    dx and dw of both nodes: the halo's adjoints carry the rest)."""
    world = mesh_shape[0] * mesh_shape[1]
    outs = [r[(mesh_shape, "k4gp")] for r in ranks[world]]
    dx_ref, dw_ref, db_ref = _jax_second_order()
    dx = np.zeros_like(dx_ref)
    for o in outs:
        (b0, b1), (h0, h1) = o["rows"], o["block"]
        dx[b0:b1, :, h0:h1] = o["dx"].numpy()
        assert (o["k4_calls"], o["k1_calls"]) == (1, 6)
    dw = sum(o["dw"].numpy() for o in outs)
    db = sum(o["db"].numpy() for o in outs)
    for what, got, ref in (("dx", dx, dx_ref), ("dw", dw, dw_ref),
                           ("db", db, db_ref)):
        err = float(np.max(np.abs(got - ref)))
        scale = max(float(np.max(np.abs(ref))), 1.0)
        assert err < GP_TOL * scale, (what, err, scale)
