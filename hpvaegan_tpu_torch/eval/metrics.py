"""Lightweight evaluation metrics (a copy of
``hpvaegan_tpu/eval/metrics.py:20-52``, numpy only).

* ``reconstruction_psnr`` — rec-mode fidelity against the real sample.
* ``diversity_score``    — mean pairwise distance between rand-mode
  samples; 0 means mode collapse.
"""
from __future__ import annotations

import numpy as np

__all__ = ["psnr", "reconstruction_psnr", "diversity_score"]


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """PSNR for [-1, 1]-normalized tensors (data_range 2.0)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def reconstruction_psnr(generated: np.ndarray, real: np.ndarray) -> float:
    return psnr(generated, real)


def diversity_score(samples: np.ndarray) -> float:
    """Mean pairwise L1 distance across the sample batch (N, ...): rand-mode
    samples from different seeds should differ; ~0 indicates collapse onto
    the reconstruction."""
    s = np.asarray(samples, np.float64)
    n = s.shape[0]
    if n < 2:
        return 0.0
    flat = s.reshape(n, -1)
    total = 0.0
    count = 0
    for i in range(n):
        for j in range(i + 1, n):
            total += float(np.mean(np.abs(flat[i] - flat[j])))
            count += 1
    return total / count
