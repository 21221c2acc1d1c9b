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

# kernel vs plain version, both f32 (and K1-dw from bf16 operands: the
# same products, f32 sums in another order): max error below
# 1e-4 * max(|y|, 1)
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


# bf16 kernel vs its plain version: the same bf16 operands, f32 sums in
# another order, one rounding to bf16 each, so an output may take the
# neighbouring bf16 value: 1 ulp, at most 2**-7 of max(|y|, 1).  K2's y
# also sees z's 1-ulp flips through conv2: 2 ulp.  dw is f32 from the
# same bf16 products: the f32 bar.
BF16_TOL, BF16_PAIR_TOL = 2.0 ** -7, 2.0 ** -6
BF16_SHAPES = [(1, 3, 9, 7, 64), (2, 5, 45, 81, 64)]
# every edge of the K1-dw bf16 tiling (128-pixel row tiles, x rows outside
# H, T steps without a temporal neighbour), of the K2 f32 one (8 x 16
# output tiles), of K1-fwd bf16's (8 x 64) and of K2 bf16's (6 x 28, the
# persistent walk's columns): W in {1, 28, 29, 57, 63, 64, 65, 129, 256},
# H in {1, 6, 7, 8, 9, 13, 144}, T in {1, 2, 3, 13}, B in {1, 2, 3}
EDGE_SHAPES = [(1, 1, 1, 1, 64), (3, 2, 7, 63, 64), (1, 13, 7, 65, 64),
               (1, 2, 144, 129, 64), (3, 1, 1, 256, 64), (1, 13, 144, 1, 64),
               (1, 2, 8, 64, 64), (2, 3, 9, 28, 64), (1, 2, 6, 29, 64),
               (3, 1, 13, 57, 64)]


def _bf16(g, dev, *shape, scale=1.0):
    return (torch.randn(shape, device=dev, generator=g) * scale).to(
        torch.bfloat16)


def _close_bf16(got, ref, tol):
    assert got.dtype == ref.dtype
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * max(float(ref.float().abs().max()), 1.0), err


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BF16_SHAPES + EDGE_SHAPES)
def test_bf16_k1_kernels_match_plain_on_card(cuda_device, shape):
    """K1's forward (with and without LeakyReLU), dx and dw in bf16: f32
    weights and bias are rounded to bf16 by the wrapper, and only the bf16
    kernels launch."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    x, dy = _bf16(g, cuda_device, *shape), _bf16(g, cuda_device, *shape)
    w = _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05)
    b = _randn(g, cuda_device, 64, scale=0.1)
    cp.counts.reset()
    ys = [cp.conv3d64(x, w, b, neg_slope=s) for s in (None, 0.2)]
    dx = cp.conv3d64_dx(dy, w)
    dw = cp.conv3d64_dw(x, dy)
    torch.cuda.synchronize()
    assert (cp.counts.fwd_bf16_launches, cp.counts.dx_bf16_launches,
            cp.counts.dw_bf16_launches) == (2, 1, 1)
    assert (cp.counts.fwd_launches, cp.counts.dx_launches,
            cp.counts.dw_launches, cp.counts.plain_calls) == (0, 0, 0, 0)
    for y, s in zip(ys, (None, 0.2)):
        _close_bf16(y, cp.conv3d64_plain(x, w, b, neg_slope=s), BF16_TOL)
    _close_bf16(dx, cp.conv3d64_plain(dy, cp.flip_swap(w)), BF16_TOL)
    assert dw.dtype == torch.float32
    _close_to_plain(dw, cp.conv3d64_dw_plain(x, dy))
    assert torch.equal(dw, cp.conv3d64_dw(x, dy))


@pytest.mark.gpu
@pytest.mark.parametrize("shape",
                         BF16_SHAPES + [(1, 1, 8, 14, 64)] + EDGE_SHAPES)
def test_bf16_pair_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(22)
    x = _bf16(g, cuda_device, *shape)
    w1, w2 = (_randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05)
              for _ in range(2))
    b1, b2 = (_randn(g, cuda_device, 64, scale=0.1) for _ in range(2))
    cf.counts.reset()
    y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
    y_only = cf.conv3d64_pair_forward(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert (cf.counts.bf16_launches, cf.counts.launches,
            cf.counts.plain_calls) == (2, 0, 0)
    y_ref, z_ref = cf.conv3d64_pair_plain(x, w1, b1, w2, b2, with_mid=True)
    _close_bf16(z, z_ref, BF16_TOL)
    _close_bf16(y, y_ref, BF16_PAIR_TOL)
    assert torch.equal(y, y_only)


@pytest.mark.gpu
def test_bf16_pair_backward_matches_plain_on_card(cuda_device):
    """dx in bf16 (1 ulp per K1-dx, two in a row), dw and db in f32 with
    dw rounded to bf16 (1 ulp).  db1 sums d_pre1, which carries dz's
    1-ulp flips: the bf16 bar; db2 sums the same d_pre2 on both sides:
    the f32 bar."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    shape = BF16_SHAPES[1]
    leaves = [_bf16(g, cuda_device, *shape),
              _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05),
              _randn(g, cuda_device, 64, scale=0.1),
              _randn(g, cuda_device, 3, 3, 3, 64, 64, scale=0.05),
              _randn(g, cuda_device, 64, scale=0.1)]
    dy = _bf16(g, cuda_device, *shape)
    leaves = [t.requires_grad_(True) for t in leaves]
    cp.counts.reset()
    got = torch.autograd.grad(cf.conv3d64_pair(*leaves), leaves, dy)
    assert (cp.counts.dx_bf16_launches, cp.counts.dw_bf16_launches) == (2, 2)
    assert cp.counts.dx_launches == cp.counts.dw_launches == 0
    x, w1, b1, w2, b2 = (t.detach() for t in leaves)
    y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
    refs = cf.conv3d64_pair_backward(x, z, y, w1, w2, dy, plain=True)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 4
    for a, b, tol in zip(got, refs, (BF16_PAIR_TOL, BF16_TOL, BF16_TOL,
                                     BF16_TOL, TOL)):
        _close_bf16(a, b, tol)


@pytest.mark.gpu
def test_bf16_failed_launch_raises(cuda_device, monkeypatch):
    """No fallback: a bf16 launch that reports a CUDA error raises, and
    nothing is counted."""
    class FailingLib:
        def __getattr__(self, name):
            return lambda *args: 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(cp, "_lib", lambda: FailingLib())
    monkeypatch.setattr(cp, "_dw_lib", lambda: FailingLib())
    monkeypatch.setattr(cf, "_lib", lambda: FailingLib())
    x = torch.zeros((1, 3, 8, 8, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 3, 64, 64), device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    cp.counts.reset()
    cf.counts.reset()
    for call in (lambda: cp.conv3d64(x, w, b), lambda: cp.conv3d64_dx(x, w),
                 lambda: cp.conv3d64_dw(x, x),
                 lambda: cf.conv3d64_pair(x, w, b, w, b)):
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            call()
    assert cp.counts == cp.KernelCounts() and cf.counts == cf.PairCounts()


@pytest.mark.gpu
def test_f32_failed_launch_raises(cuda_device, monkeypatch):
    """No fallback in f32 either (K2's f32 kernel and K1's): a launch that
    reports a CUDA error raises, and nothing is counted."""
    class FailingLib:
        def __getattr__(self, name):
            return lambda *args: 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(cp, "_lib", lambda: FailingLib())
    monkeypatch.setattr(cp, "_dw_lib", lambda: FailingLib())
    monkeypatch.setattr(cf, "_lib", lambda: FailingLib())
    x = torch.zeros((1, 3, 8, 8, 64), device=cuda_device)
    w = torch.zeros((3, 3, 3, 64, 64), device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    cp.counts.reset()
    cf.counts.reset()
    for call in (lambda: cf.conv3d64_pair_forward(x, w, b, w, b),
                 lambda: cf.conv3d64_pair_forward(x, w, b, w, b,
                                                  with_mid=True),
                 lambda: cp.conv3d64(x, w, b), lambda: cp.conv3d64_dw(x, x)):
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            call()
    assert cp.counts == cp.KernelCounts() and cf.counts == cf.PairCounts()


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


# W 7 and 81 leave ragged tiles of every kernel (K1 32, K1-dw f32 64 and bf16
# 128, K2 f32 16 and bf16 14)
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
@pytest.mark.parametrize("shape", GRAD_SHAPES + [(1, 1, 8, 14, 64)]
                         + EDGE_SHAPES)
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
    _close_to_plain(y_only, y_ref)
    assert torch.equal(y, y_only)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [GRAD_SHAPES[1], EDGE_SHAPES[2]])
def test_pair_backward_matches_plain_on_card(cuda_device, shape):
    """The kernels' backward (K1-dx, K1-dw through both masks) against the
    plain versions on the same x, z, y: with masks from another forward a
    pre-activation that rounds to the other side of zero flips one
    neighbourhood of the gradient."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
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
    _gan_step_gives_every_kernel_weight_a_gradient(cuda_device, bf16=False)


@pytest.mark.gpu
def test_bf16_gan_step_on_card_gives_every_kernel_weight_a_gradient(
        cuda_device):
    """The same under ``--bf16``: only the bf16 kernels launch, and every
    routed (f32) weight gets a finite, non-zero f32 gradient."""
    _gan_step_gives_every_kernel_weight_a_gradient(cuda_device, bf16=True)
    assert cf.counts.launches == cp.counts.fwd_launches == 0
    assert cp.counts.dx_launches == cp.counts.dw_launches == 0
    assert cp.counts.fwd_bf16_launches > 0 and cp.counts.dw_bf16_launches > 0


def _gan_step_gives_every_kernel_weight_a_gradient(cuda_device, bf16):
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=3, enc_blocks=1, vae_levels=2, pconv_all=True,
                 pfuse=True, bf16=bf16)
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
    assert (cf.counts.bf16_launches if bf16 else cf.counts.launches) == 2
    routed = [b.conv.weight for b in G.body[-1].blocks]
    routed += [b.weight for b in D.body]  # one K2 pair, one K1 block
    assert all(b.conv.kernel_route for b in G.body[-1].blocks)
    for w in routed:
        assert w.grad is not None and w.grad.dtype == torch.float32
        assert bool(torch.isfinite(w.grad).all())
        assert float(w.grad.abs().max()) > 0


def _small_models(name, bf16=False, scale=3, **over):
    """A full-width ``name`` model and its critic on a small pyramid,
    seeded, on the CPU (nfc 64 under --pconv --pconv-all --pfuse)."""
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
                 num_layer=3, enc_blocks=1, vae_levels=2, pconv=True,
                 pconv_all=True, pfuse=True, bf16=bf16, generator=name,
                 **over)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = scale
    gen = torch.Generator().manual_seed(0)
    G = make_generator(name, cfg, cfg.pyramid(), ndim=3).init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = make_discriminator(cfg.discriminator, cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    return cfg, G, D


def _draws(cfg, G, seed=2):
    pyr, scale = cfg.pyramid(), cfg.scale_idx
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = dict(real=np.tanh(draw(2, *pyr.shape3d(scale), 3)),
               real_zero=np.tanh(draw(2, *pyr.shape3d(0), 3)),
               noise_init=draw(2, *pyr.shape3d(0), cfg.latent_dim),
               z=draw(2, *pyr.shape3d(0), 3))
    if G.returns_triple:
        out["noises"] = [draw(2, *pyr.shape3d(i + 1), 3)
                         for i in range(len(G.body))]
        out["eps"] = (draw(2, 1, 1, 1, cfg.latent_dim),
                      rng.uniform(size=(2, *pyr.shape3d(0), 1)).astype(
                          np.float32))
        out["latents"] = (draw(2, 1, 1, 1, cfg.latent_dim),
                          rng.integers(0, 2, (2, *pyr.shape3d(0), 1)).astype(
                              np.float32))
    else:
        out["noises"] = [None] + [draw(*G._noise_shape(i, 2))
                                  for i in range(1, len(G.body))]
    return out


def _step(cfg, G, D, x):
    opt_g = optim.build_g_optimizer(cfg, G, cfg.scale_idx)
    opt_d = optim.build_d_optimizer(cfg, D)
    if G.returns_triple:
        return steps.gan_step(G, D, opt_g, opt_d, cfg, x["real"],
                              x["real_zero"], x["noise_init"],
                              [1.0, 0.3, 0.2, 0.1], noises=x["noises"],
                              eps=x["eps"], alpha=0.37,
                              latents=x["latents"])
    x0 = x["noise_init"][..., :3]
    return steps.baseline_step(G, D, opt_g, opt_d, cfg, x["real"], x0,
                               x["z"], [1.0, 0.3, 0.2, 0.1],
                               noises=x["noises"], alphas=[0.37])


@pytest.mark.gpu
def test_two_f32_train_scale_runs_are_bit_equal_on_card(cuda_device):
    """The repaired fault: cuDNN's default f32 weight gradients summed in
    an order that changed from run to run, so two f32 runs of the same
    seeds ended with different weights; the steps now hold cuDNN's
    deterministic algorithms (``hpvaegan_tpu_torch.deterministic``)."""
    from hpvaegan_tpu_torch.train.trainer import train_scale
    cfg, G0, _ = _small_models("GeneratorHPVAEGAN")
    cfg.niter = 3
    pyr = cfg.pyramid()
    x = _draws(cfg, G0)
    ends = []
    for _ in range(2):
        G = copy.deepcopy(G0).to(cuda_device)
        cfg.Noise_Amps = [1.0, 0.3, 0.2]

        def batches():
            while True:
                yield x["real"], x["real_zero"]

        _, D, hist = train_scale(cfg, G, batches(), seed=5)
        torch.cuda.synchronize()
        ends.append({**{f"G.{k}": v.clone() for k, v in
                        G.state_dict().items()},
                     **{f"D.{k}": v.clone() for k, v in
                        D.state_dict().items()}})
        assert len(hist) == 3 and pyr.shape3d(3)
    assert not torch.backends.cudnn.deterministic   # restored after
    for k, v in ends[0].items():
        assert torch.equal(v, ends[1][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["GeneratorVAE_nb", "GeneratorCSG"])
def test_new_generators_step_on_card_matches_cpu(cuda_device, name):
    """One GAN step of a ``GeneratorVAE_nb`` (K1 in its stages, K2 and K1
    in the critic) and one baseline step of a ``GeneratorCSG`` (the SN
    critic's kernels) on the card against the CPU path, from the same
    weights and draws: metrics, BatchNorm statistics and u/v at the f32
    bar."""
    cfg, G, D = _small_models(name)
    x = _draws(cfg, G)
    got = {}
    for where, g, d in (("cpu", G, D),
                        ("cuda", copy.deepcopy(G).to(cuda_device),
                         copy.deepcopy(D).to(cuda_device))):
        cp.counts.reset()
        cf.counts.reset()
        metrics = _step(cfg, g, d, x)
        if where == "cuda":
            torch.cuda.synchronize()
            assert cp.counts.plain_calls == cf.counts.plain_calls == 0
            assert cf.counts.launches > 0 and cp.counts.dw_launches > 0
        got[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: v.cpu().numpy() for m in (g, d)
                       for k, v in m.named_buffers(prefix=type(m).__name__)})
    for a, b in zip(got["cuda"], got["cpu"]):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# K3: the fused conv3d + bias + LeakyReLU for any channel count
# ---------------------------------------------------------------------------

# (shape of x, C_out): the encoder head's 3 -> 64, the body's 64 -> 64, the
# tail's 64 -> 3 at a stage shape with ragged tiles, and ragged channels at
# T = 1, 2 and 4 (the Pallas function's XLA branch below T = 3)
K3_CASES = [((2, 5, 45, 81, 3), 64), ((1, 4, 19, 37, 64), 64),
            ((2, 5, 45, 81, 64), 3), ((1, 1, 9, 7, 5), 7),
            ((1, 2, 9, 7, 5), 7), ((1, 4, 9, 7, 5), 7)]
# every instance across its boundaries: C_in 1, 3, 4 (narrow_in) and 5,
# 64 (wide) into C_out 9, 64, 65, 130 (two and three channel blocks); C_out
# 1, 3, 8 (narrow_out) from C_in 1, 4, 5, 64; H and W off the tiles (4 x
# 32, 8 x 64), T 1, 2 and 4
K3_EDGES = [((1, 4, 9, 37, 1), 9), ((2, 1, 35, 67, 3), 65),
            ((1, 2, 17, 33, 4), 64), ((1, 3, 9, 37, 2), 130),
            ((1, 4, 9, 37, 5), 9), ((2, 1, 35, 67, 64), 65),
            ((1, 2, 17, 33, 5), 64), ((1, 3, 6, 35, 17), 130),
            ((1, 4, 9, 37, 64), 1), ((2, 1, 35, 67, 4), 3),
            ((1, 2, 17, 33, 5), 8), ((1, 7, 20, 70, 64), 8),
            ((1, 6, 33, 65, 1), 3)]
# (C_in, C_out) -> the launch configuration the CPU tests of k3_plan
# assume (tests/test_torch_port_k3_plan.py): instance, tile rows, tile
# columns, output channels a tile, blocks an SM
K3_CONFIGS = {(3, 64): ("narrow_in", 4, 32, 64, 4),
              (64, 64): ("wide", 4, 32, 64, 2),
              (64, 3): ("narrow_out", 8, 64, 3, 3),
              (64, 8): ("narrow_out", 8, 64, 8, 3)}


def _k3_inputs(g, dev, shape, c_out):
    x = _randn(g, dev, *shape)
    w = _randn(g, dev, 3, 3, 3, shape[-1], c_out,
               scale=(27 * shape[-1]) ** -0.5)
    return x, w, _randn(g, dev, c_out, scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,c_out", K3_CASES + K3_EDGES)
def test_k3_kernel_matches_plain_on_card(cuda_device, shape, c_out):
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3
    g = torch.Generator(device=cuda_device).manual_seed(31)
    x, w, b = _k3_inputs(g, cuda_device, shape, c_out)
    k3.counts.reset()
    y = k3.conv3d_lrelu(x, w, b)
    torch.cuda.synchronize()
    assert (k3.counts.launches, k3.counts.plain_calls) == (1, 0)
    assert k3.counts.by_instance == {k3.k3_instance(shape[-1], c_out): 1}
    assert y.shape == (*shape[:4], c_out) and y.dtype == torch.float32
    _close_to_plain(y, k3.conv3d_lrelu_plain(x, w, b))
    # a bf16 x is widened to f32 first
    yb = k3.conv3d_lrelu(x.to(torch.bfloat16), w, b)
    _close_to_plain(yb, k3.conv3d_lrelu_plain(x.to(torch.bfloat16).float(),
                                              w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,c_out", [K3_CASES[0], K3_CASES[3]])
def test_k3_gradients_match_autograd_through_plain_on_card(cuda_device,
                                                           shape, c_out):
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3
    g = torch.Generator(device=cuda_device).manual_seed(32)
    inputs = _k3_inputs(g, cuda_device, shape, c_out)
    dy = _randn(g, cuda_device, *shape[:4], c_out)
    got_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = k3.conv3d_lrelu(*got_leaves)
    got = torch.autograd.grad(y, got_leaves, dy)
    # the mask from the kernel's own y: one from the plain forward would
    # flip wherever an output rounds to the other side of zero
    d_pre = torch.where(y.detach() >= 0, dy, k3.NEG_SLOPE * dy)
    ref = torch.autograd.grad(
        k3.conv3d_lrelu_plain(*ref_leaves, neg_slope=1.0), ref_leaves, d_pre)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", sorted(K3_CONFIGS))
def test_k3_config_is_what_the_plan_tests_assume(cuda_device, channels):
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plan tests model a 132-SM H100")
    cfg = k3.kernel_config(*channels)
    assert (cfg["instance"], cfg["tile_h"], cfg["tile_w"], cfg["co_blk"],
            cfg["blocks_per_sm"]) == K3_CONFIGS[channels]


@pytest.mark.gpu
def test_k3_failed_launch_raises(cuda_device, monkeypatch):
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3

    class FailingLib:
        def __getattr__(self, name):
            return lambda *args: 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(k3, "_lib", lambda: FailingLib())
    x = torch.zeros((1, 3, 8, 8, 3), device=cuda_device)
    w = torch.zeros((3, 3, 3, 3, 64), device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    k3.counts.reset()
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        k3.conv3d_lrelu(x, w, b)
    assert k3.counts == k3.LReLUCounts()


@pytest.mark.gpu
def test_training_cli_runs_on_card(cuda_device, tmp_path):
    """The training entry point on the card at full width on a tiny
    pyramid of the in-repo clip (its frames file is committed): the K1
    and K2 kernels launch, the plain versions never run, and the JAX
    package's file set is written."""
    import logging
    import os

    from hpvaegan_tpu_torch.cli import train_video
    root = logging.getLogger()
    handlers = list(root.handlers)
    cp.counts.reset()
    cf.counts.reset()
    try:
        cfg = train_video.main([
            "--video-path", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "data", "vids", "wingsuit.avi"),
            "--img-size", "24",
            "--min-size", "12", "--max-size", "24", "--niter", "1",
            "--vae-levels", "2", "--latent-dim", "8", "--enc-blocks", "1",
            "--num-layer", "3", "--manualSeed", "3", "--pconv", "--pconv-all",
            "--pfuse", "--run-dir", str(tmp_path)])
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    torch.cuda.synchronize()
    assert cp.counts.plain_calls == cf.counts.plain_calls == 0
    assert cp.counts.fwd_launches > 0 and cp.counts.dw_launches > 0
    assert cf.counts.launches > 0
    exp = os.path.join(str(tmp_path), "wingsuit", "DEBUG", "experiment_0")
    for name in ["netG", "Noise_Amps", "Noise_Amps.json", "config.json"] + [
            f"netD_{s}" for s in range(2, cfg.stop_scale + 1)]:
        assert os.path.exists(os.path.join(exp, name)), name


# ---- the sampling surface: SamplerSession's rand, rec and inject batches
# and the coalescing server, on the card against the CPU path ----

SAMPLE_CFG = dict(nfc=64, latent_dim=128, num_layer=5, enc_blocks=2,
                  vae_levels=3, img_size=48, min_size=24, max_size=48,
                  pconv_all=True, video_path="data/vids/wingsuit.avi")


def _sampling_checkpoint(directory, bf16: bool, seed: int = 5) -> str:
    """A full-width generator with random weights from ``seed`` on a small
    pyramid, grown to its top scale, saved with its config.json."""
    import json
    import os

    from hpvaegan_tpu_torch.utils.saver import save_generator
    cfg = Config(**SAMPLE_CFG, bf16=bf16)
    cfg.ar, cfg.org_fps = 144 / 256, 24.0
    cfg.adjust_scales()
    gen = torch.Generator().manual_seed(seed)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(gen)
    for _ in range(cfg.stop_scale):
        G.init_next_stage(gen)
    os.makedirs(directory, exist_ok=True)
    netG = os.path.join(directory, "netG")
    save_generator(netG, G, cfg.stop_scale,
                   [1.0] + [cfg.noise_amp] * cfg.stop_scale)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg.snapshot_dict(), f)
    return netG


def _session(netG, device):
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    cfg = Config(netG=netG)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return SamplerSession(cfg, batch_size=2, manual_seed=0, device=device)


def _three_modes(sess, seed: int = 9):
    """Rand, rec and inject-from-1 batches on draws made from ``seed``."""
    pyr, scale = sess.pyramid, sess.scale
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    noises = [draw(2, *pyr.shape3d(i + 1), 3) for i in range(scale)]
    return {
        "rand": sess.sample_batch(noise=draw(*sess.noise_shape),
                                  noises=noises),
        "rec": sess.reconstruct_batch(
            np.tanh(draw(2, *pyr.shape3d(0), 3)),
            eps=draw(2, *pyr.shape3d(0), sess.cfg.latent_dim)),
        "inject": sess.inject_batch(np.tanh(draw(2, *pyr.shape3d(1), 3)), 1,
                                    noises=noises)}


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_session_batches_match_the_cpu_path_on_card(cuda_device, tmp_path,
                                                    bf16):
    """chip_smoke.py's bars: f32 within the tests' f32 bar; bf16 no
    further from the CPU bf16 path, in RMS, than the CPU bf16 path is from
    the CPU f32 path on the same weights and draws (nor twice that in
    max)."""
    netG = _sampling_checkpoint(tmp_path / "run", bf16)
    cp.counts.reset()
    card = _three_modes(_session(netG, cuda_device))
    torch.cuda.synchronize()
    launches = cp.counts.fwd_bf16_launches if bf16 else cp.counts.fwd_launches
    assert launches > 0 and cp.counts.plain_calls == 0
    cpu = _three_modes(_session(netG, "cpu"))
    if bf16:
        f32 = _three_modes(_session(
            _sampling_checkpoint(tmp_path / "f32", False), "cpu"))
    for mode in ("rand", "rec", "inject"):
        assert card[mode].shape == cpu[mode].shape
        assert np.all(np.isfinite(card[mode]))
        if not bf16:
            np.testing.assert_allclose(card[mode], cpu[mode], rtol=RTOL,
                                       atol=ATOL)
            continue
        diff, noise = card[mode] - cpu[mode], cpu[mode] - f32[mode]
        rms = float(np.sqrt(np.mean(diff ** 2)))
        bar = float(np.sqrt(np.mean(noise ** 2)))
        assert rms <= bar, (mode, rms, bar)
        assert np.abs(diff).max() <= 2 * np.abs(noise).max(), mode


@pytest.mark.gpu
def test_coalesced_requests_on_card_are_distinct(cuda_device, tmp_path):
    import threading

    from hpvaegan_tpu_torch.cli.serve import Server
    from hpvaegan_tpu_torch.utils.video_io import read_avi
    sess = _session(_sampling_checkpoint(tmp_path / "run", False),
                    cuda_device)
    server = Server(sess, str(tmp_path / "out"), default_num=1, seed0=0,
                    coalesce_ms=500.0)
    resps = [None] * 4

    def go(i):
        resps[i] = server.handle({"num_samples": 1, "prefix": f"c{i}"})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.close()
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r["ok"] for r in resps), resps
    assert server.coalescer.dispatches <= 2
    clips = [read_avi(r["paths"][0])[0].astype(int) for r in resps]
    for i in range(4):
        for j in range(i + 1, 4):
            assert np.abs(clips[i] - clips[j]).mean() > 0, (i, j)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["conv2", "conv3b"])
def test_c3d_features_on_card_match_the_cpu(cuda_device, layer):
    """The random C3D trunk's statistics and SVFID on the card against
    the CPU's (f32 features, float64 moments): within 1e-4 of the
    largest entry, SVFID within 1e-3."""
    from hpvaegan_tpu_torch.eval import _svfid, svfid
    from hpvaegan_tpu_torch.eval.c3d import random_c3d_params
    rng = np.random.default_rng(1)
    clips = [np.tanh(rng.standard_normal((8, 40, 48, 3))).astype(np.float32)
             for _ in range(2)]
    params = random_c3d_params(layer, 0)
    for clip in clips:
        card = _svfid.c3d_feature_stats(params, clip, layer,
                                        device=cuda_device)
        cpu = _svfid.c3d_feature_stats(params, clip, layer, device="cpu")
        for got, want in zip(card, cpu):
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got = svfid(clips[0], clips[1:], feature_layer=layer,
                device=cuda_device)["mean"]
    want = svfid(clips[0], clips[1:], feature_layer=layer,
                 device="cpu")["mean"]
    assert got > 0 and abs(got - want) <= 1e-3 * want


@pytest.mark.gpu
@pytest.mark.parametrize("tap", ["Conv2d_2a_3x3", "pool1"])
def test_stem_features_on_card_match_the_cpu(cuda_device, tap):
    from hpvaegan_tpu_torch.eval import _sifid, sifid
    rng = np.random.default_rng(2)
    images = [np.tanh(rng.standard_normal((72, 96, 3))).astype(np.float32)
              for _ in range(2)]
    params = _sifid.random_stem_params(tap, 0)
    for image in images:
        card = _sifid.image_feature_stats(params, image, tap,
                                          device=cuda_device)
        cpu = _sifid.image_feature_stats(params, image, tap, device="cpu")
        for got, want in zip(card, cpu):
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got = sifid(images[0], images[1:], tap=tap, device=cuda_device)["mean"]
    want = sifid(images[0], images[1:], tap=tap, device="cpu")["mean"]
    assert got > 0 and abs(got - want) <= 1e-3 * want


def _image_checkpoint(run_dir):
    """A full-width 2D run's files from random weights on a small pyramid:
    netG and config.json, beside a PNG of the image."""
    import json
    import os

    from hpvaegan_tpu_torch.utils.png import encode_png
    from hpvaegan_tpu_torch.utils.saver import save_generator
    os.makedirs(run_dir)
    image = os.path.join(str(run_dir), "frame.png")
    rng = np.random.default_rng(3)
    with open(image, "wb") as f:
        f.write(encode_png(rng.integers(0, 256, (36, 64, 3), np.uint8)))
    cfg = Config(image_path=image, nfc=64, latent_dim=128, num_layer=5,
                 vae_levels=3, img_size=48, min_size=24, max_size=48)
    cfg.ar = 36 / 64
    cfg.adjust_scales()
    G = make_generator(cfg.generator, cfg, cfg.pyramid2d(), ndim=2)
    gen = torch.Generator().manual_seed(4)
    G.init(gen)
    for _ in range(cfg.stop_scale):
        G.init_next_stage(gen)
    netG = os.path.join(str(run_dir), "netG")
    save_generator(netG, G, cfg.stop_scale,
                   [1.0] + [0.1] * cfg.stop_scale)
    with open(os.path.join(str(run_dir), "config.json"), "w") as f:
        json.dump(cfg.snapshot_dict(), f)
    return netG


@pytest.mark.gpu
def test_2d_session_batches_match_the_cpu_path_on_card(cuda_device,
                                                       tmp_path):
    """A 2D SamplerSession (stock convs: no kernel runs) on the card and
    on the CPU, on the same draws: the tests' f32 bar."""
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    netG = _image_checkpoint(tmp_path / "run")

    def batches(device):
        cfg = Config(netG=netG)
        apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
        cfg.adjust_scales()
        sess = SamplerSession(cfg, batch_size=2, device=device)
        pyr, rng = sess.pyramid, np.random.default_rng(5)
        noises = [rng.standard_normal((2, *pyr.shape2d(i + 1), 3)).astype(
            np.float32) for i in range(sess.scale)]
        noise = rng.standard_normal(sess.noise_shape).astype(np.float32)
        eps = rng.standard_normal((2, *pyr.shape2d(0), 128)).astype(
            np.float32)
        return {"rand": sess.sample_batch(noise=noise, noises=noises),
                "rec": sess.reconstruct_batch(eps=eps)}

    cp.counts.reset()
    card = batches(cuda_device)
    torch.cuda.synchronize()
    assert cp.counts.fwd_launches == 0 and cp.counts.plain_calls == 0
    cpu = batches("cpu")
    for mode in ("rand", "rec"):
        # the top of the 48-px pyramid at the image's aspect ratio
        assert card[mode].shape == cpu[mode].shape == (2, 27, 48, 3)
        np.testing.assert_allclose(card[mode], cpu[mode], rtol=RTOL,
                                   atol=ATOL)
