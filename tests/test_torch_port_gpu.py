"""Tests of the port that need a CUDA card; they skip without one.

On the card, from the root of the repository:

    python -m pytest -m gpu tests/test_torch_port_gpu.py -q

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (add ``--noconftest`` there: tests/conftest.py pins
JAX to the CPU).
"""
import copy

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.train import optim, steps

# kernel vs plain version, both f32: max error below 1e-4 * max(|y|, 1)
TOL = 1e-4
RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import or collection: every worker
    collects the same tests, and these skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.gpu
@pytest.mark.parametrize("neg_slope", [None, 0.2])
@pytest.mark.parametrize("shape", [(1, 3, 9, 7, 64), (2, 5, 45, 81, 64)])
def test_kernel_matches_plain_on_card(cuda_device, shape, neg_slope):
    """A ragged shape smaller than one tile, and the main path's scale-4
    stage shape (odd W, H not a multiple of the tile)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(shape, device=cuda_device, generator=g)
    w = torch.randn((3, 3, 3, 64, 64), device=cuda_device, generator=g) * 0.05
    b = torch.randn(64, device=cuda_device, generator=g) * 0.1
    cp.counts.reset()
    got = cp.conv3d64(x, w, b, neg_slope=neg_slope)
    torch.cuda.synchronize()
    assert cp.counts.fwd_launches == 1 and cp.counts.plain_calls == 0
    ref = cp.conv3d64_plain(x, w, b, neg_slope=neg_slope)
    err = float((got - ref).abs().max())
    assert err < TOL * max(float(ref.abs().max()), 1.0), err


@pytest.mark.gpu
def test_kernel_rejects_bf16_on_card(cuda_device):
    x = torch.zeros((1, 3, 8, 8, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 3, 64, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32"):
        cp.conv3d64(x, w)


@pytest.mark.gpu
def test_generator_on_card_matches_cpu_path(cuda_device):
    """The tiny nfc-64 generator under pconv_all on the card (K1 + cuDNN)
    and on the CPU (plain versions), same weights and draws."""
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    pyr = cfg.pyramid()
    gen = torch.Generator().manual_seed(0)
    G = make_generator(cfg.generator, cfg, pyr, ndim=3).init(gen)
    G.init_next_stage(gen).init_next_stage(gen)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, *pyr.shape3d(0), 8), dtype=np.float32)
    noises = [rng.standard_normal((2, *pyr.shape3d(i + 1), 3),
                                  dtype=np.float32) for i in range(2)]
    amps = [1.0, 0.3, 0.2]
    outs = []
    for model in (G, copy.deepcopy(G).to(cuda_device)):
        cp.counts.reset()
        with torch.inference_mode():
            out, _, _ = model.apply(amps, noise_init=z, mode="rand",
                                    noises=noises)
        outs.append(out.cpu().numpy())
    assert cp.counts.fwd_launches == cfg.num_layer * 2
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def _close_to_plain(got, ref):
    err = float((got - ref).abs().max())
    assert err < TOL * max(float(ref.abs().max()), 1.0), err


def _randn(g, dev, *shape, scale=1.0):
    return torch.randn(shape, device=dev, generator=g) * scale


# W 7 and 81 leave ragged tiles of every kernel (K1 32, K1-dw 64, K2 14)
GRAD_SHAPES = [(1, 3, 9, 7, 64), (2, 5, 45, 81, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_dx_and_dw_kernels_match_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = _randn(g, cuda_device, *shape)
    dy = _randn(g, cuda_device, *shape)
    w = _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05)
    cp.counts.reset()
    dx = cp.conv3d64_dx(dy, w)
    dw = cp.conv3d64_dw(x, dy)
    torch.cuda.synchronize()
    assert (cp.counts.dx_launches, cp.counts.dw_launches,
            cp.counts.plain_calls) == (1, 1, 0)
    _close_to_plain(dx, cp.conv3d64_plain(dy, cp.flip_swap(w)))
    _close_to_plain(dw, cp.conv3d64_dw_plain(x, dy))
    # the same result from run to run: no atomics
    assert torch.equal(dw, cp.conv3d64_dw(x, dy))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAD_SHAPES + [(1, 1, 8, 14, 64)])
def test_pair_kernel_matches_plain_on_card(cuda_device, shape):
    """T=1: both temporal neighbours of z lie outside the volume."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = _randn(g, cuda_device, *shape)
    w1, w2 = (_randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05)
              for _ in range(2))
    b1, b2 = (_randn(g, cuda_device, 64, scale=0.1) for _ in range(2))
    cf.counts.reset()
    y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
    y_only = cf.conv3d64_pair_forward(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert cf.counts.launches == 2 and cf.counts.plain_calls == 0
    y_ref, z_ref = cf.conv3d64_pair_plain(x, w1, b1, w2, b2, with_mid=True)
    _close_to_plain(z, z_ref)
    _close_to_plain(y, y_ref)
    assert torch.equal(y, y_only)


@pytest.mark.gpu
def test_pair_backward_matches_plain_on_card(cuda_device):
    """The kernels' backward (K1-dx, K1-dw through both masks) against the
    plain versions on the same x, z, y: with masks from another forward a
    pre-activation that rounds to the other side of zero flips one
    neighbourhood of the gradient."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    shape = GRAD_SHAPES[1]
    leaves = [_randn(g, cuda_device, *shape),
              _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05),
              _randn(g, cuda_device, 64, scale=0.1),
              _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05),
              _randn(g, cuda_device, 64, scale=0.1)]
    dy = _randn(g, cuda_device, *shape)
    leaves = [t.requires_grad_(True) for t in leaves]
    cp.counts.reset()
    got = torch.autograd.grad(cf.conv3d64_pair(*leaves), leaves, dy)
    assert (cp.counts.dx_launches, cp.counts.dw_launches) == (2, 2)
    x, w1, b1, w2, b2 = (t.detach() for t in leaves)
    y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
    refs = cf.conv3d64_pair_backward(x, z, y, w1, w2, dy, plain=True)
    for a, b in zip(got, refs):
        _close_to_plain(a, b)


@pytest.mark.gpu
def test_second_order_use_raises_on_card(cuda_device):
    x = torch.randn(1, 3, 8, 8, 64, device=cuda_device, requires_grad=True)
    w = torch.randn(3, 3, 3, 64, 64, device=cuda_device) * 0.05
    y = cp.conv3d64(x, w, neg_slope=0.2)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


@pytest.mark.gpu
def test_gan_step_on_card_gives_every_kernel_weight_a_gradient(cuda_device):
    """The repaired fault: a K1- or K2-routed weight gets a gradient on the
    card (the forward used to fill a tensor through ctypes with no
    ``grad_fn``, so the optimizer silently skipped it)."""
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=3, enc_blocks=1, vae_levels=2, pconv_all=True,
                 pfuse=True)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = 3
    pyr = cfg.pyramid()
    gen = torch.Generator().manual_seed(0)
    G = make_generator(cfg.generator, cfg, pyr, ndim=3).init(gen)
    for _ in range(cfg.scale_idx):
        G.init_next_stage(gen)
    G.to(cuda_device).requires_grad_(True)
    D = make_discriminator(cfg.discriminator, cfg, 3).to(cuda_device)
    draw = torch.Generator(device=cuda_device).manual_seed(1)
    real = torch.rand((2, *pyr.shape3d(3), 3), device=cuda_device,
                      generator=draw) * 2 - 1
    real_zero = torch.rand((2, *pyr.shape3d(0), 3), device=cuda_device,
                           generator=draw) * 2 - 1
    noise_init = torch.randn((2, *pyr.shape3d(0), 8), device=cuda_device,
                             generator=draw)
    cp.counts.reset()
    cf.counts.reset()
    metrics = steps.gan_step(G, D, optim.build_g_optimizer(cfg, G, 3),
                             optim.build_d_optimizer(cfg, D), cfg, real,
                             real_zero, noise_init, [1.0, 0.3, 0.2, 0.1],
                             generator=draw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in metrics.values())
    assert cp.counts.plain_calls == cf.counts.plain_calls == 0
    assert cf.counts.launches == 2
    routed = [b.conv.weight for b in G.body[-1].blocks]
    routed += [b.weight for b in D.body]  # one K2 pair, one K1 block
    assert all(b.conv.kernel_route for b in G.body[-1].blocks)
    for w in routed:
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
        assert float(w.grad.abs().max()) > 0
