"""The device-resident frame cache (port of
``hpvaegan_tpu/data/device_cache.py``): the trainer's default data path,
as in the JAX package (``train/trainer.py:149-167``; ``--host-loader``
keeps ``data/loader.BatchLoader``).

The scale's frame stores (``device_cache_views`` of the video and image
datasets: the current scale's and the zero scale's, float32 in [-1, 1];
scale 0 takes its own store twice) go to the device once.  Each batch is
then a gather there: the strided temporal crop ``idx + arange(td) *
every`` of each store at the sample's start index (the image datasets:
the image ``idx``), and one hflip shared by both members of the pair
(``make_sample_gather``, ``device_cache.py:48-78``).  The start indices
and flips are the rows of the cache stream (``loader.cache_row``,
``device_cache.py:141-169``), a pure function of ``(seed, iteration)``;
the loader's counter advances one row a batch (``next``) or ``k`` rows
a chunk (``draw``), as the JAX loader's does.  The values are the host
path's (``SingleVideoDataset.pairs`` on the same rows) exactly: a gather
copies, it computes nothing.

The rows stay on the host until a step asks for them: ``rows`` returns
them as small device tensors, and ``gather`` turns them into the batch
inside the step, so a step replayed as a CUDA graph
(``train/graphs.py``) takes its rows from static buffers and gathers
its own batch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .loader import cache_row

__all__ = ["DeviceCacheLoader"]


class DeviceCacheLoader:
    """``(real, real_zero)`` batches gathered on ``device`` from the
    scale's stores; an iterator like ``BatchLoader``, plus the rows
    (``rows``, ``draw``) and the gather (``gather``) apart."""

    def __init__(self, dataset, batch_size: int, seed: int, scale_idx: int,
                 device="cpu", start_iteration: int = 0, views=None):
        """``views``: the dataset's ``device_cache_spec(scale_idx)``,
        where the stores are built beside another scale's training
        (``--compile-ahead``); by default ``device_cache_views``."""
        device = torch.device(device)
        cur, zero, n_start, kw = (views if views is not None else
                                  dataset.device_cache_views(scale_idx))
        kw = dict(kw)
        self.hflip = bool(kw.pop("hflip"))
        self._n = int(kw.pop("virtual_len"))
        self._n_start = int(n_start)
        self.batch_size = int(batch_size)
        self.device = device
        self._seed = int(seed)
        self._it = int(start_iteration)
        self._memo: dict = {}
        self._cur = torch.from_numpy(np.ascontiguousarray(cur)).to(device)
        self._zero = torch.from_numpy(np.ascontiguousarray(zero)).to(device)
        self._video = "td" in kw
        if self._video:
            self._offsets = torch.arange(kw["td"], device=device) \
                * kw["every"]
            self._offsets0 = torch.arange(kw["td0"], device=device) \
                * kw["every0"]

    @property
    def iteration(self) -> int:
        """The iteration of the next row."""
        return self._it

    def _row(self, it: int) -> Tuple[np.ndarray, np.ndarray]:
        return cache_row(self._seed, it, self._n, self._n_start,
                         self.batch_size, self.hflip, self._memo)

    def draw(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """((k, B) start indices, (k, B) flips) of the next ``k`` rows;
        advances the counter by ``k`` (``device_cache.py:183-194``)."""
        rows = [self._row(self._it + j) for j in range(k)]
        self._it += k
        return (np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]))

    def rows(self, idxs: np.ndarray, flips: np.ndarray
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One row as ``((B,) int64, (B,) bool)`` device tensors."""
        return (torch.from_numpy(np.asarray(idxs, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(flips, bool)).to(self.device))

    def gather(self, idx: torch.Tensor, flip: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(real, real_zero)`` of one row on the device: NTHWC clips
        (NHWC images), each flipped along W where ``flip`` is set."""
        if self._video:
            cur = self._cur[idx[:, None] + self._offsets]
            zero = self._zero[idx[:, None] + self._offsets0]
            w_axis = 3
        else:
            cur, zero = self._cur[idx], self._zero[idx]
            w_axis = 2
        if self.hflip:
            mask = flip.reshape((-1,) + (1,) * (cur.dim() - 1))
            cur = torch.where(mask, cur.flip(w_axis), cur)
            zero = torch.where(mask, zero.flip(w_axis), zero)
        return cur, zero

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        idxs, flips = self.draw(1)
        return self.gather(*self.rows(idxs[0], flips[0]))

    def close(self) -> None:   # symmetry with BatchLoader
        pass
