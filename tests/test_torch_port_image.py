"""The port's 2D data path on the CPU: the PNG reader
(``hpvaegan_tpu_torch/utils/png.py``) against imageio, the image datasets
(``hpvaegan_tpu_torch/data/image.py``) and the loader's image flavour
against ``hpvaegan_tpu.data.image`` and the JAX loaders, the frames file
of a non-PNG image, and ``ImageSaver``/``write_png`` against the JAX
saver's cv2 write.  Everything is compared bit for bit: the reader and
the resize are exact."""
import os
import shutil
import struct
import zlib

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.data import DeviceCacheLoader
from hpvaegan_tpu.data.image import MultipleImageDataset as JMulti
from hpvaegan_tpu.data.image import SingleImageDataset as JSingle
from hpvaegan_tpu.data.loader import BatchLoader as JBatchLoader
from hpvaegan_tpu.utils.saver import ImageSaver as JImageSaver
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.data.image import (MultipleImageDataset,
                                           SingleImageDataset, read_image)
from hpvaegan_tpu_torch.data.loader import BatchLoader
from hpvaegan_tpu_torch.tools.decode_frames import decode_image, main
from hpvaegan_tpu_torch.utils.png import (PNG_SIGNATURE, _png_chunk,
                                          encode_png, is_png, read_png)
from hpvaegan_tpu_torch.utils.saver import ImageSaver, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_IMAGE = os.path.join(REPO, "tests", "assets", "test_image.png")
TINY = dict(img_size=16, min_size=8, max_size=16)


def _pixels(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_reader_equals_imageio_on_the_test_image():
    got = read_png(TEST_IMAGE)
    want = np.asarray(imageio.imread(TEST_IMAGE))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert is_png(TEST_IMAGE)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_round_trip_every_filter(tmp_path, channels, filter_type):
    """``encode_png`` rows under each filter type, read back by the port
    and by imageio."""
    img = _pixels(channels * 10 + filter_type, (13, 17, channels))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
    got, want = read_png(path), np.asarray(imageio.imread(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_reader_reads_what_opencv_writes(tmp_path):
    """OpenCV's encoder picks its own filter per row."""
    img = (np.add.outer(np.arange(31), np.arange(45))[..., None]
           * np.array([1, 3, 7])).astype(np.uint8)
    img[::3] = _pixels(1, img[::3].shape)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img[..., ::-1])
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("depth,color,interlace,match", [
    (16, 2, 0, "16-bit RGB"), (8, 3, 0, "palette"),
    (8, 4, 0, "gray \\+ alpha"), (8, 2, 1, "interlaced")])
def test_reader_refuses_what_it_does_not_read(tmp_path, depth, color,
                                              interlace, match):
    """A header the reader does not take fails before the image data."""
    header = struct.pack(">IIBBBBB", 9, 8, depth, color, 0, 0, interlace)
    path = tmp_path / "x.png"
    path.write_bytes(PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                     + _png_chunk(b"IDAT", zlib.compress(bytes(100)))
                     + _png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=match):
        read_png(str(path))


def test_reader_checks_signature_and_crc(tmp_path):
    path = str(tmp_path / "x.png")
    data = bytearray(encode_png(_pixels(3, (4, 4, 3))))
    data[40] ^= 0xFF   # inside the IDAT chunk
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(path)
    open(path, "wb").write(b"GIF89a" + bytes(40))
    assert not is_png(path)
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(path)


def _cfgs(path, **over):
    jcfg, cfg = JConfig(image_path=path, **{**TINY, **over}), \
        Config(image_path=path, **{**TINY, **over})
    jcfg.adjust_scales()
    cfg.adjust_scales()
    return jcfg, cfg


def _image_dir(tmp_path):
    d = tmp_path / "images"
    d.mkdir()
    for i in range(3):
        img = _pixels(10 + i, (24, 30, 4 if i == 1 else 3))
        (d / f"im{i}.png").write_bytes(encode_png(img, i))
    return str(d)


@pytest.fixture(params=["single", "multi"])
def datasets(request, tmp_path):
    if request.param == "single":
        jcfg, cfg = _cfgs(TEST_IMAGE, hflip=True, data_rep=3)
        return JSingle(jcfg), SingleImageDataset(cfg), jcfg, cfg
    path = _image_dir(tmp_path)
    jcfg, cfg = _cfgs(path, hflip=True, data_rep=2)
    return JMulti(jcfg), MultipleImageDataset(cfg), jcfg, cfg


def test_per_scale_arrays_equal_jax(datasets):
    jds, ds, jcfg, cfg = datasets
    assert cfg.ar == jcfg.ar and len(ds) == len(jds)
    for scale in range(cfg.stop_scale + 1):
        got, want = ds._scaled(scale), jds._scaled(scale)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_get_and_batch_equal_jax(datasets):
    jds, ds, _, cfg = datasets
    for scale in (0, cfg.stop_scale):
        for idx, flip in ((0, False), (1, True), (len(ds) - 1, True)):
            (a, az), (b, bz) = ds.get(idx, scale, flip), jds.get(idx, scale,
                                                                 flip)
            np.testing.assert_array_equal(a, b)
            assert (az is None) == (bz is None) == (scale == 0)
            if az is not None:
                np.testing.assert_array_equal(az, bz)
        idxs = np.array([0, 2, 5])
        for got, want in zip(ds.batch(np.random.default_rng(4), idxs, scale),
                             jds.batch(np.random.default_rng(4), idxs,
                                       scale)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stream", ["cache", "host"])
def test_loader_streams_equal_the_jax_loaders(datasets, stream):
    """The image flavour of both streams: the cache stream against
    ``DeviceCacheLoader``'s 2D gather, the host stream against
    ``BatchLoader``, across an epoch boundary."""
    jds, ds, _, cfg = datasets
    scale, batch, seed = cfg.stop_scale, 2, 7 * 1000 + 1
    if stream == "cache":
        jl = DeviceCacheLoader(jds, batch, seed=seed, scale_idx=scale)
    else:
        jl = JBatchLoader(jds, batch, seed=seed, scale_idx=scale,
                          device=jax.devices("cpu")[0])
    loader = BatchLoader(ds, batch, seed=seed, scale_idx=scale,
                         stream=stream)
    try:
        for _ in range(8):
            real, real_zero = next(loader)
            want, want_zero = next(jl)
            assert real.dtype == torch.float32 and real.dim() == 4
            np.testing.assert_array_equal(real.numpy(), np.asarray(want))
            np.testing.assert_array_equal(real_zero.numpy(),
                                          np.asarray(want_zero))
    finally:
        loader.close()
        jl.close()


def test_missing_path_and_frames_file(tmp_path):
    _, cfg = _cfgs(str(tmp_path / "nope.png"))
    with pytest.raises(FileNotFoundError, match="nope.png"):
        SingleImageDataset(cfg)
    with pytest.raises(FileNotFoundError):
        MultipleImageDataset(cfg)
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, _pixels(4, (20, 26, 3)))
    _, cfg = _cfgs(jpg)
    with pytest.raises(FileNotFoundError, match="tools.decode_frames"):
        SingleImageDataset(cfg)


def test_non_png_image_through_its_frames_file(tmp_path):
    """A BMP (lossless: OpenCV and imageio decode the same pixels) decoded
    once by the tool trains as the JAX dataset reads it; a directory
    skips the frames files beside its images."""
    img = _pixels(5, (20, 26, 3))
    bmp = str(tmp_path / "photo.bmp")
    cv2.imwrite(bmp, img[..., ::-1])
    main([bmp])
    assert os.path.isfile(str(tmp_path / "photo.frames.npz"))
    np.testing.assert_array_equal(read_image(bmp), img)
    jcfg, cfg = _cfgs(bmp)
    jds, ds = JSingle(jcfg), SingleImageDataset(cfg)
    for scale in range(cfg.stop_scale + 1):
        np.testing.assert_array_equal(ds._scaled(scale), jds._scaled(scale))
    d = tmp_path / "dir"
    d.mkdir()
    shutil.copy(TEST_IMAGE, d / "a.png")
    gray = str(d / "b.bmp")
    cv2.imwrite(gray, _pixels(6, (64, 64)))
    decode_image(gray)
    _, cfg = _cfgs(str(d))
    ds = MultipleImageDataset(cfg)
    assert len(ds.images) == 2 and ds.images[1].shape == (64, 64, 3)


def test_gray_png_is_refused_by_the_datasets(tmp_path):
    path = str(tmp_path / "gray.png")
    (tmp_path / "gray.png").write_bytes(encode_png(_pixels(7, (9, 9, 1))))
    with pytest.raises(ValueError, match="RGB or RGBA"):
        read_image(path)


def test_image_saver_writes_what_the_jax_saver_writes(tmp_path):
    """The experiment tree named after the image, and ``save_image``'s
    PNG equal to the JAX saver's cv2 write of the same array."""
    jcfg, cfg = _cfgs(TEST_IMAGE)
    jcfg.run_dir = cfg.run_dir = str(tmp_path / "run")
    jsaver, saver = JImageSaver(jcfg), ImageSaver(cfg, run_id=1)
    assert saver.experiment_dir == jsaver.experiment_dir.replace(
        "experiment_0", "experiment_1")
    assert os.path.isdir(saver.eval_dir)
    x = np.tanh(np.random.default_rng(8).standard_normal(
        (11, 14, 3))).astype(np.float32)
    jsaver.save_image(x, "a.png")
    saver.save_image(x, "b.png")
    np.testing.assert_array_equal(
        read_png(os.path.join(saver.eval_dir, "b.png")),
        np.asarray(imageio.imread(os.path.join(jsaver.eval_dir, "a.png"))))
    with pytest.raises(ValueError, match="PNG only"):
        write_png(x, str(tmp_path / "c.jpg"))
