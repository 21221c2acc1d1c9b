"""The port's data slice (``hpvaegan_tpu_torch/data``, the frames tool)
against the JAX package's ``SingleVideoDataset``, ``BatchLoader`` and
``DeviceCacheLoader`` on the same clips: the test clip with the JAX e2e
test's tiny pyramid (tests/test_train_video_e2e.py:11-15) and
``data/vids/wingsuit.avi`` with the default pyramid.  Frames and batches
must be equal, not close: the port's per-scale resize reproduces
OpenCV's, and its index and flip streams are the JAX loaders'."""
import os
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.data.device_cache import DeviceCacheLoader
from hpvaegan_tpu.data.loader import BatchLoader as JBatchLoader
from hpvaegan_tpu.data.video import SingleVideoDataset as JDataset
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.data.loader import BatchLoader
from hpvaegan_tpu_torch.data.video import (SingleVideoDataset, read_frames,
                                           resize_linear)
from hpvaegan_tpu_torch.tools.decode_frames import decode_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CLIP = os.path.join(REPO, "tests", "assets", "test_video.avi")
WINGSUIT = os.path.join(REPO, "data", "vids", "wingsuit.avi")
TINY = dict(img_size=16, min_size=8, max_size=16)


@pytest.fixture(scope="module")
def test_clip(tmp_path_factory):
    """The test clip copied into a temporary directory, its frames file
    made beside it by the tool."""
    d = tmp_path_factory.mktemp("clip")
    clip = str(d / "test_video.avi")
    shutil.copy(TEST_CLIP, clip)
    assert decode_frames(clip) == str(d / "test_video.frames.npz")
    return clip


def _datasets(clip, **over):
    jcfg, cfg = JConfig(video_path=clip, **over), Config(video_path=clip,
                                                         **over)
    for c in (jcfg, cfg):
        c.adjust_scales()
    return JDataset(jcfg), SingleVideoDataset(cfg)


def _clip(name, test_clip):
    return (test_clip, TINY) if name == "test_video" else (WINGSUIT, {})


@pytest.mark.parametrize("name", ["test_video", "wingsuit"])
def test_frames_equal_the_jax_dataset_at_every_scale(name, test_clip):
    clip, over = _clip(name, test_clip)
    jds, ds = _datasets(clip, **over)
    assert (ds.cfg.ar, ds.cfg.org_fps, ds.cfg.fps_lcm) == \
        (jds.cfg.ar, jds.cfg.org_fps, jds.cfg.fps_lcm)
    assert ds.org_frame_size == jds.org_frame_size
    assert ds.zero_scale_frames.dtype == np.float32
    np.testing.assert_array_equal(ds.zero_scale_frames,
                                  jds.zero_scale_frames)
    for scale in range(ds.cfg.stop_scale + 1):
        ds.generate_frames(scale)
        jds.generate_frames(scale)
        assert ds.frames.shape == jds.frames.shape
        np.testing.assert_array_equal(ds.frames, jds.frames, err_msg=scale)


def test_committed_frames_file_equals_a_fresh_decode(tmp_path):
    fresh = decode_frames(WINGSUIT, str(tmp_path / "wingsuit.frames.npz"))
    frames, fps = read_frames(WINGSUIT)
    with np.load(fresh) as data:
        np.testing.assert_array_equal(frames, data["frames"])
        assert fps == float(data["fps"]) == 24.0
    assert frames.shape == (13, 144, 256, 3) and frames.dtype == np.uint8


@pytest.mark.parametrize("size", [
    (72, 128), (18, 33), (57, 102), (10, 7), (143, 255),
    # upscales of the 144 x 256 clip: W only, H only, both, one axis up
    # and the other down, an exact 2x
    (144, 300), (200, 256), (200, 300), (100, 300), (200, 200), (288, 512)])
def test_resize_equals_cv2(size):
    """(72, 128) is an exact 2x downscale, where cv2 takes INTER_AREA; an
    upscale's first and last rows read the edge row twice with their
    fractional weights."""
    frames, _ = read_frames(WINGSUIT)
    h, w = size
    got = resize_linear(frames[:3], h, w)
    for frame, mine in zip(frames[:3], got):
        np.testing.assert_array_equal(
            mine, cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR))


def test_missing_frames_file_names_the_tool(tmp_path):
    clip = str(tmp_path / "clip.avi")
    shutil.copy(TEST_CLIP, clip)
    cfg = Config(video_path=clip, **TINY)
    cfg.adjust_scales()
    with pytest.raises(FileNotFoundError, match="tools.decode_frames"):
        SingleVideoDataset(cfg)


def test_get_batch_pairs_flips_and_len(test_clip):
    """``get`` (clip + zero-scale pair, shared hflip), ``batch`` (flip
    coins from the rng) and ``__len__`` (with data_rep) as the JAX
    dataset's."""
    jds, ds = _datasets(test_clip, hflip=True, data_rep=2, **TINY)
    assert len(ds) == len(jds) == (40 - 12) * 2
    for scale in (0, 2):
        ds.generate_frames(scale)
        jds.generate_frames(scale)
        for idx, flip in ((0, False), (5, True), (len(ds) - 1, True)):
            (a, az), (b, bz) = ds.get(idx, flip, scale), jds.get(idx, flip,
                                                                 scale)
            np.testing.assert_array_equal(a, b)
            assert (az is None) == (bz is None) == (scale == 0)
            if az is not None:
                np.testing.assert_array_equal(az, bz)
        idxs = np.array([3, 17, 40])
        for got, want in zip(ds.batch(np.random.default_rng(4), idxs, scale),
                             jds.batch(np.random.default_rng(4), idxs,
                                       scale)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("stream", ["cache", "host"])
def test_loader_streams_equal_the_jax_loaders(stream, start, test_clip):
    """The cache stream against ``DeviceCacheLoader``, the host stream
    (``--host-loader``) against ``BatchLoader``: the same batches for the
    first iterations and from a ``start_iteration``, at a pair scale;
    data_rep 2 with batch 4 spans an epoch boundary."""
    jds, ds = _datasets(test_clip, hflip=True, data_rep=2, **TINY)
    scale, batch, seed = 2, 4, 5 * 1000 + 2
    ds.generate_frames(scale)
    jds.generate_frames(scale)
    if stream == "cache":
        jl = DeviceCacheLoader(jds, batch, seed=seed, scale_idx=scale,
                               start_iteration=start)
    else:
        jl = JBatchLoader(jds, batch, seed=seed, scale_idx=scale,
                          device=jax.devices("cpu")[0],
                          start_iteration=start)
    loader = BatchLoader(ds, batch, seed=seed, scale_idx=scale,
                         stream=stream, start_iteration=start)
    try:
        for _ in range(16):
            real, real_zero = next(loader)
            want, want_zero = next(jl)
            assert real.dtype == torch.float32 and real.device.type == "cpu"
            np.testing.assert_array_equal(real.numpy(), np.asarray(want))
            np.testing.assert_array_equal(real_zero.numpy(),
                                          np.asarray(want_zero))
    finally:
        loader.close()
        jl.close()
