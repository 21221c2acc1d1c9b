"""The port's sample metrics (``hpvaegan_tpu_torch/eval/metrics.py``) equal
the JAX package's (``hpvaegan_tpu/eval/metrics.py``) exactly, on seeded
arrays, on fewer than two samples and on identical arrays."""
import math

import numpy as np
import pytest

from hpvaegan_tpu.eval import metrics as jm
from hpvaegan_tpu_torch import eval as pe
from hpvaegan_tpu_torch.eval import metrics as pm

SHAPES = [(2, 3, 4, 5, 3), (3, 2, 6, 6, 3), (5, 1, 4, 4, 3), (4, 8, 8, 3)]


def _arrays(seed, shape):
    rng = np.random.default_rng(seed)
    a = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    b = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    return a, b


def test_the_package_exports_only_the_three_metrics():
    assert sorted(pe.__all__) == ["diversity_score", "psnr",
                                  "reconstruction_psnr"]
    assert not hasattr(pe, "svfid") and not hasattr(pe, "sifid")


@pytest.mark.parametrize("seed,shape", list(enumerate(SHAPES)))
def test_psnr_equals_jax(seed, shape):
    a, b = _arrays(seed, shape)
    assert pm.psnr(a, b) == jm.psnr(a, b)
    assert pm.psnr(a, b, data_range=1.0) == jm.psnr(a, b, data_range=1.0)
    assert pm.reconstruction_psnr(a, b) == jm.reconstruction_psnr(a, b)


@pytest.mark.parametrize("seed,shape", list(enumerate(SHAPES)))
def test_diversity_equals_jax(seed, shape):
    a, _ = _arrays(seed, shape)
    assert pm.diversity_score(a) == jm.diversity_score(a)
    assert pm.diversity_score(a) > 0


@pytest.mark.parametrize("n", [0, 1])
def test_diversity_of_fewer_than_two_samples(n):
    a = np.ones((n, 2, 3, 3), np.float32)
    assert pm.diversity_score(a) == jm.diversity_score(a) == 0.0


def test_psnr_of_identical_arrays_is_infinite():
    a, _ = _arrays(7, SHAPES[0])
    assert pm.psnr(a, a.copy()) == jm.psnr(a, a.copy()) == math.inf
    assert pm.reconstruction_psnr(a, a) == math.inf
