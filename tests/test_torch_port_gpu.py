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
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

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
    assert cp.counts.launches == 1 and cp.counts.plain_calls == 0
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
    assert cp.counts.launches == cfg.num_layer * 2
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
