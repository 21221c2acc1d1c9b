"""The port's device-resident frame cache (``data/device_cache.py``) against
the JAX package's (``hpvaegan_tpu/data/device_cache.py``) on the CPU.

Held: the gather of the video stores (strided temporal crop, the zero
scale's pair, scale 0 taking its own store twice) against JAX's
``_gather_chunk`` and the image stores' against ``_gather_chunk_2d``, at
scale 0 and above, hflip on and off, bit for bit; the loader's batches
against the JAX ``DeviceCacheLoader``'s and against the host-assembled
batches of the same rows (``BatchLoader``'s cache stream); the CLI's
default path is the cache; and the rows the trainer takes under
``--scan-steps 3`` against the JAX trainer's use of
``DeviceCacheLoader`` (``next`` for the calibration, then ``draw(k)`` a
chunk of k > 1, so the chunk's rows start after the calibration's:
PARITY.md deviation 10), and under ``--scan-steps 1`` one row an
iteration from the calibration's on."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.data import DeviceCacheLoader as JCacheLoader
from hpvaegan_tpu.data import SingleImageDataset as JImageDataset
from hpvaegan_tpu.data import SingleVideoDataset as JVideoDataset
from hpvaegan_tpu.data.device_cache import _gather_chunk, _gather_chunk_2d
from hpvaegan_tpu_torch.cli import train_video
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.data import device_cache
from hpvaegan_tpu_torch.data.device_cache import DeviceCacheLoader
from hpvaegan_tpu_torch.data.image import SingleImageDataset
from hpvaegan_tpu_torch.data.loader import BatchLoader, make_loader
from hpvaegan_tpu_torch.data.video import SingleVideoDataset
from hpvaegan_tpu_torch.tools.decode_frames import decode_frames
from hpvaegan_tpu_torch.utils.logger import kept_logging
from torch_port_runs import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
TINY = dict(img_size=16, min_size=8, max_size=16)
CLI = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
       "--niter", "7", "--nfc", "8", "--num-layer", "2", "--batch-size",
       "2", "--manualSeed", "5", "--latent-dim", "8", "--enc-blocks", "1",
       "--vae-levels", "2", "--no-cuda"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    path = str(d / "test_video.avi")
    shutil.copy(os.path.join(ASSETS, "test_video.avi"), path)
    decode_frames(path)
    return path


def _video(clip, **over):
    jcfg, cfg = (JConfig(video_path=clip, **TINY, **over),
                 Config(video_path=clip, **TINY, **over))
    for c in (jcfg, cfg):
        c.adjust_scales()
    return JVideoDataset(jcfg), SingleVideoDataset(cfg)


def _image(**over):
    path = os.path.join(ASSETS, "test_image.png")
    jcfg, cfg = (JConfig(image_path=path, **TINY, **over),
                 Config(image_path=path, **TINY, **over))
    for c in (jcfg, cfg):
        c.adjust_scales()
    return JImageDataset(jcfg), SingleImageDataset(cfg)


def _rows(n_start, hflip):
    idxs = np.array([0, 3, n_start - 1, 2], np.int64) % n_start
    flips = np.array([True, False, True, hflip]) & hflip
    return idxs, flips


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("scale", [0, 2])
def test_video_gather_equals_jax(clip, scale, hflip):
    jds, ds = _video(clip, hflip=hflip)
    loader = DeviceCacheLoader(ds, 4, seed=1, scale_idx=scale)
    cur, zero, n_start, kw = jds.device_cache_views(scale)
    kw = dict(kw)
    kw.pop("virtual_len")
    idxs, flips = _rows(n_start, hflip)
    want = _gather_chunk(jnp.asarray(cur), jnp.asarray(zero),
                         jnp.asarray(idxs[None], jnp.int32),
                         jnp.asarray(flips.reshape(1, 4, 1, 1, 1, 1)), **kw)
    got = loader.gather(*loader.rows(idxs, flips))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w[0]))
    # the host path's batch of the same rows
    for g, w in zip(got, ds.pairs(idxs, flips, scale)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("scale", [0, 2])
def test_image_gather_equals_jax(scale, hflip):
    jds, ds = _image(hflip=hflip)
    loader = DeviceCacheLoader(ds, 4, seed=1, scale_idx=scale)
    cur, zero, n_start, _ = jds.device_cache_views(scale)
    idxs, flips = _rows(n_start, hflip)
    want = _gather_chunk_2d(jnp.asarray(cur), jnp.asarray(zero),
                            jnp.asarray(idxs[None], jnp.int32),
                            jnp.asarray(flips.reshape(1, 4, 1, 1, 1)),
                            hflip=hflip)
    got = loader.gather(*loader.rows(idxs, flips))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w[0]))


@pytest.mark.parametrize("start", [0, 5])
def test_loader_batches_equal_jax_and_the_host_assembly(clip, start):
    """The same batches as the JAX cache loader's and as ``BatchLoader``
    assembling the cache stream's rows on the host, from a
    ``start_iteration`` too, across an epoch boundary."""
    jds, ds = _video(clip, hflip=True, data_rep=2)
    scale, batch, seed = 2, 4, 5 * 1000 + 2
    jl = JCacheLoader(jds, batch, seed=seed, scale_idx=scale,
                      start_iteration=start)
    loader = DeviceCacheLoader(ds, batch, seed=seed, scale_idx=scale,
                               start_iteration=start)
    host = BatchLoader(ds, batch, seed=seed, scale_idx=scale,
                       stream="cache", start_iteration=start)
    try:
        for _ in range(12):
            got, want, on_host = next(loader), next(jl), next(host)
            for g, w, h in zip(got, want, on_host):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                assert torch.equal(g, h)
    finally:
        host.close()
    assert loader.iteration == start + 12


def test_make_loader_takes_the_cache_unless_host_loader(clip):
    _, ds = _video(clip)
    cfg = ds.cfg
    cfg.batch_size = 2
    assert isinstance(make_loader(ds, cfg, 5, 1, "cpu"), DeviceCacheLoader)
    cfg.host_loader = True
    loader = make_loader(ds, cfg, 5, 1, "cpu")
    try:
        assert isinstance(loader, BatchLoader) and loader.stream == "host"
    finally:
        loader.close()


def _jax_trainer_rows(jds, scale, seed, niter, k_max):
    """The rows the JAX trainer's loop takes from its DeviceCacheLoader
    (trainer.py:239-240, 270-341): the calibration's (``next``), then per
    chunk ``draw(k)`` for k > 1 or ``next`` for k == 1 (the first
    iteration's batch being the calibration's); one row an iteration."""
    jl = JCacheLoader(jds, 2, seed=seed * 1000 + scale, scale_idx=scale)
    calib = jl.draw(1)
    rows, it = [], 0
    while it < niter:
        k = min(k_max, niter - it)
        if k == 1:
            rows.append(calib if it == 0 else jl.draw(1))
        else:
            idxs, flips = jl.draw(k)
            rows += [(idxs[j:j + 1], flips[j:j + 1]) for j in range(k)]
        it += k
    return calib, rows


@pytest.mark.parametrize("scan", [3, 1])
def test_trainer_rows_follow_the_jax_trainer(clip, tmp_path, monkeypatch,
                                             scan):
    """The rows each iteration's step gathers, scale by scale."""
    taken = []
    gather = device_cache.DeviceCacheLoader.gather

    def record(self, idx, flip):
        taken.append((self._seed, idx.numpy().copy(), flip.numpy().copy()))
        return gather(self, idx, flip)

    monkeypatch.setattr(device_cache.DeviceCacheLoader, "gather", record)
    with kept_logging():
        cfg = train_video.main(["--video-path", clip, *CLI, "--run-dir",
                                str(tmp_path), "--scan-steps", str(scan)])
    jds, _ = _video(clip)
    for scale in range(cfg.stop_scale + 1):
        jds.generate_frames(scale)
        mine = [t for t in taken if t[0] == 5 * 1000 + scale]
        calib, rows = _jax_trainer_rows(jds, scale, 5, 7, scan)
        assert len(mine) == 1 + len(rows)   # the calibration's, each step's
        for (_, idx, flip), (want_i, want_f) in zip(mine, [calib] + rows):
            np.testing.assert_array_equal(idx, want_i[0])
            np.testing.assert_array_equal(flip, np.ravel(want_f[0]))
