"""Batch loader: shuffled epochs, drop_last, one background thread that
assembles batches on the host and copies them to the device (port of
``hpvaegan_tpu/data/loader.py``; reference DataLoader(shuffle=True,
drop_last=True), train_video.py:364-368).

Two index and flip streams, each a pure function of ``(seed, iteration)``
so that a resume at ``start_iteration`` consumes exactly the batches the
uninterrupted run would have:

* ``"cache"`` (the default, as the JAX trainer's default path): the
  stream of ``DeviceCacheLoader._row``
  (``hpvaegan_tpu/data/device_cache.py:141-169``):
  ``SeedSequence(entropy=seed, spawn_key=(it,))`` per iteration, epoch
  permutations keyed ``(0xE90C, epoch)``, flips from the same row rng;
* ``"host"`` (``--host-loader``): ``BatchLoader``'s stream
  (``loader.py:51-81``): permutations keyed ``[seed, 2, epoch]``, flips
  drawn by the dataset from ``[seed, 3, it]``.

Both give the JAX loaders' batches under the same flags, for the video
dataset (NTHWC clips) and the image datasets (NHWC images) alike.  Here
the store stays on the host and each batch is copied, from pinned memory
with ``non_blocking=True``.  The trainer's default is the device-resident
cache instead (``data/device_cache.py``, as the JAX package's default),
which gathers the ``"cache"`` stream's rows on the device from stores
uploaded once a scale; ``make_loader`` returns it, and ``BatchLoader``
with the ``"host"`` stream under ``--host-loader``.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["BatchLoader", "cache_row", "host_indices", "make_loader"]


def cache_row(seed: int, it: int, n: int, n_start: int, batch_size: int,
              hflip: bool, perm_memo: dict) -> Tuple[np.ndarray, np.ndarray]:
    """((B,) start indices, (B,) flips) of iteration ``it`` in the device
    cache's stream over ``n`` virtual samples (``device_cache.py:151-169``).
    """
    if n <= 0:
        raise ValueError("dataset is empty")
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(it,)))
    if n < batch_size:
        flat = rng.integers(0, n, batch_size)
    else:
        per_epoch = n // batch_size  # drop_last: full batches only
        epoch = it // per_epoch
        if perm_memo.get("epoch") != epoch:
            perm_memo["epoch"] = epoch
            perm_memo["perm"] = np.random.default_rng(
                np.random.SeedSequence(entropy=seed,
                                       spawn_key=(0xE90C, epoch))
            ).permutation(n)
        slot = (it % per_epoch) * batch_size
        flat = perm_memo["perm"][slot:slot + batch_size]
    idxs = (flat % n_start).astype(np.int32)
    flips = rng.random(batch_size) < 0.5 if hflip \
        else np.zeros(batch_size, bool)
    return idxs, flips


def host_indices(seed: int, it: int, n: int, batch_size: int,
                 perm_memo: dict) -> np.ndarray:
    """Sample indices of iteration ``it`` in the host loader's stream
    (``loader.py:51-66``): with replacement when the dataset is smaller
    than a batch (the reference would spin forever there)."""
    if n < batch_size:
        return np.random.default_rng([seed, 1, it]).integers(0, n,
                                                             batch_size)
    per_epoch = n // batch_size
    epoch, slot = divmod(it, per_epoch)
    if perm_memo.get("epoch") != epoch:
        perm_memo["epoch"] = epoch
        perm_memo["perm"] = np.random.default_rng(
            [seed, 2, epoch]).permutation(n)
    start = slot * batch_size
    return perm_memo["perm"][start:start + batch_size]


_PREFETCH = 2   # batches assembled ahead of the step


class BatchLoader:
    """Infinite iterator over ``(real, real_zero)`` float32 NTHWC (NHWC)
    tensors on ``device``, assembled two batches ahead by one thread."""

    def __init__(self, dataset, batch_size: int, seed: int, scale_idx: int,
                 device="cpu", stream: str = "cache",
                 start_iteration: int = 0):
        if stream not in ("cache", "host"):
            raise ValueError(f"unknown stream {stream!r} (cache|host)")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.scale_idx = scale_idx
        self.device = torch.device(device)
        self.stream = stream
        self._seed = int(seed)
        self._it0 = int(start_iteration)
        self._queue: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"loader-scale-{scale_idx}")
        self._thread.start()

    def _assemble(self, it: int, perm_memo: dict):
        ds, n = self.dataset, len(self.dataset)
        if n <= 0:
            raise ValueError(
                "dataset is empty: the clip has <= fps_lcm frames "
                "(datasets/video.py:41-42 semantics)")
        if self.stream == "host":
            indices = host_indices(self._seed, it, n, self.batch_size,
                                   perm_memo)
            return ds.batch(np.random.default_rng([self._seed, 3, it]),
                            indices, self.scale_idx)
        idxs, flips = cache_row(self._seed, it, n, ds.n_starts,
                                self.batch_size,
                                bool(ds.cfg.hflip), perm_memo)
        return ds.pairs(idxs, flips, self.scale_idx)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned staging buffer; the caching host allocator keeps it
            # until the copy queued on the current stream has run
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _worker(self) -> None:
        try:
            it, perm_memo = self._it0, {}
            while not self._stop.is_set():
                real, real_zero = self._assemble(it, perm_memo)
                it += 1
                batch = (self._to_device(real), self._to_device(real_zero))
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # noqa: BLE001 - re-raised in __next__
            self._error = exc

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # poll, so that a dead worker raises instead of hanging
        while True:
            if self._error is not None:
                raise RuntimeError("BatchLoader worker died") from self._error
            try:
                return self._queue.get(timeout=1.0)
            except queue.Empty:
                continue

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def make_loader(dataset, cfg, seed: int, scale_idx: int, device,
                start_iteration: int = 0, views=None):
    """The trainer's loader, seeded ``seed * 1000 + scale_idx``
    (``hpvaegan_tpu/train/trainer.py:149-167``): the device-resident
    cache (``data/device_cache.DeviceCacheLoader``, from ``views`` when
    given), or ``BatchLoader`` on the host stream under
    ``--host-loader``."""
    from .device_cache import DeviceCacheLoader
    seed = seed * 1000 + scale_idx
    if not cfg.host_loader:
        return DeviceCacheLoader(dataset, cfg.batch_size, seed=seed,
                                 scale_idx=scale_idx, device=device,
                                 start_iteration=start_iteration,
                                 views=views)
    return BatchLoader(dataset, cfg.batch_size, seed=seed,
                       scale_idx=scale_idx, device=device, stream="host",
                       start_iteration=start_iteration)
