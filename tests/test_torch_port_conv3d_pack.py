"""K1 forward of the port (``hpvaegan_tpu_torch/ops/kernels/conv3d_pack.py``).

On the CPU the wrapper runs its plain version; it is held against the JAX
package's Pallas kernel run by the Pallas interpreter, as
tests/test_pconv.py runs it.  The CUDA kernel itself is held against the
plain version by tests/test_torch_port_gpu.py, which runs only on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.ops.pallas.conv3d_pack as jcp
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

# test_pconv.py:49-57: max error below 1e-4 * max(|y|, 1) in f32
TOL = 1e-4


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, w, b


def _assert_close(got, ref):
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(got - ref)))
    assert err < TOL * scale, (err, scale)


@pytest.mark.parametrize("neg_slope", [None, 0.2])
@pytest.mark.parametrize("shape", [(1, 3, 8, 4, 64), (2, 4, 9, 6, 64)])
def test_cpu_matches_pallas_interpret(shape, neg_slope):
    """(2,4,9,6,64): H=9 leaves a ragged H block in the Pallas kernel."""
    x, w, b = _inputs(shape, seed=sum(shape))
    ref = np.asarray(jcp.conv3d64_pallas(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), neg_slope=neg_slope,
                                         interpret=True))
    cp.counts.reset()
    got = cp.conv3d64(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), neg_slope=neg_slope)
    assert cp.counts.plain_calls == 1 and cp.counts.launches == 0
    assert got.shape == x.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), ref)


def test_plain_without_bias_matches_torch_conv():
    """b=None is a zero bias; the plain version equals F.conv3d (taps are
    a correlation, THWIO weights)."""
    x, w, _ = _inputs((1, 3, 5, 7, 64), seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = cp.conv3d64_plain(xt, wt)
    ref = torch.nn.functional.conv3d(xt.permute(0, 4, 1, 2, 3),
                                     wt.permute(4, 3, 0, 1, 2), padding=1)
    _assert_close(got.numpy(), ref.permute(0, 2, 3, 4, 1).numpy())


@pytest.mark.parametrize("case", ["x_channels", "x_rank", "w_shape",
                                  "b_shape", "dtype", "noncontiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(1, 3, 4, 4, 64)
    w = torch.zeros(3, 3, 3, 64, 64)
    b = torch.zeros(64)
    if case == "x_channels":
        x = torch.zeros(1, 3, 4, 4, 32)
    elif case == "x_rank":
        x = torch.zeros(3, 4, 4, 64)
    elif case == "w_shape":
        w = torch.zeros(3, 3, 3, 64, 32)
    elif case == "b_shape":
        b = torch.zeros(32)
    elif case == "dtype":
        x = x.double()
    else:
        x = torch.zeros(1, 3, 4, 8, 64)[:, :, :, ::2]
    with pytest.raises((ValueError, NotImplementedError)):
        cp.conv3d64(x, w, b)
