"""The port's TensorBoard writer (``utils/tb_events.py``,
``utils/summaries.py``) against tensorboardX and the JAX package's
``TensorboardSummary``: CRC32C, tag cleaning and the video tiling equal
tensorboardX's; the same calls through both give event files that
TensorBoard's loader reads, with the same tags and scalars and the same
PNG grids pixel for pixel; each GIF decodes to the tiled clips' frames
within the colour cube's 26/255; neptune routing as in
tests/test_summaries.py."""
import glob
import io
import types

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_file_loader import (
    EventFileLoader, RawEventFileLoader)
from tensorboard.compat.proto import event_pb2
from tensorboardX import summary as tbx_summary
from tensorboardX import utils as tbx_utils
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.record_writer import masked_crc32c as tbx_masked

from hpvaegan_tpu.utils.summaries import TensorboardSummary as JSummary
from hpvaegan_tpu_torch.utils import tb_events
from hpvaegan_tpu_torch.utils.summaries import (TensorboardSummary,
                                                prepare_video)


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 4095, 4097, 70001,
                               300007])
def test_crc32c_equals_tensorboardx(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tb_events.crc32c(data) == tbx_crc32c(data)
    assert tb_events.masked_crc32c(data) == tbx_masked(data)


@pytest.mark.parametrize("tag", ["Video/Scale 2/rec loss", "/a/b c",
                                 "Image/Scale 0/Fake VAE var", "x-y.z/w_1",
                                 "a(b)c%d"])
def test_tags_are_cleaned_as_tensorboardx_cleans_them(tag):
    assert tb_events.clean_tag(tag) == tbx_summary._clean_tag(tag)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
def test_prepare_video_equals_tensorboardx(b):
    clips = np.random.default_rng(b).uniform(
        0, 1, (b, 3, 5, 6, 3)).astype(np.float32)
    ref = tbx_utils._prepare_video(clips.transpose(0, 1, 4, 2, 3))
    got = prepare_video(clips)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _cfg(scale_idx=2, fps=4):
    return types.SimpleNamespace(scale_idx=scale_idx, fps=fps)


def _drive(summary, vids, imgs):
    summary.add_scalar("Video/Scale 2/rec loss", 0.5, 10)
    summary.add_scalar("Video/Scale 2/errG", -1.25, 11)
    summary.add_scalar("Video/Scale 2/noise_amp", np.float32(0.1), 11)
    summary.visualize_video(_cfg(), 10, vids, "Real")
    summary.visualize_video(_cfg(), 11, vids[:1], "Fake var")
    summary.visualize_image(_cfg(), 10, imgs, "Generated")
    summary.close()


def _events(directory):
    files = glob.glob(f"{directory}/*tfevents*")
    assert len(files) == 1, files
    list(EventFileLoader(files[0]).Load())   # TensorBoard reads it
    events = [event_pb2.Event.FromString(raw)
              for raw in RawEventFileLoader(files[0]).Load()]
    assert events[0].file_version == "brain.Event:2"
    return [(e.step, v) for e in events[1:] for v in e.summary.value]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    rng = np.random.default_rng(0)
    vids = rng.uniform(-1.1, 1.1, (3, 4, 10, 12, 3)).astype(np.float32)
    imgs = rng.uniform(-1, 1, (4, 10, 12, 3)).astype(np.float32)
    j_dir = tmp_path_factory.mktemp("jax_events")
    p_dir = tmp_path_factory.mktemp("port_events")
    _drive(JSummary(str(j_dir)), vids, imgs)
    _drive(TensorboardSummary(str(p_dir)), vids, imgs)
    return _events(j_dir), _events(p_dir), vids


def test_same_tags_and_scalars_as_jax(both):
    jax_values, port_values, _ = both
    assert ([(s, v.tag) for s, v in port_values]
            == [(s, v.tag) for s, v in jax_values])
    assert "Video/Scale_2/Real_unfold" in {v.tag for _, v in port_values}
    scalars = [(s, v.tag, v.simple_value) for s, v in port_values
               if v.WhichOneof("value") == "simple_value"]
    assert len(scalars) == 3
    assert scalars == [(s, v.tag, v.simple_value) for s, v in jax_values
                       if v.WhichOneof("value") == "simple_value"]


def _png(value):
    return np.asarray(Image.open(io.BytesIO(
        value.image.encoded_image_string)))


def test_png_grids_equal_tensorboardx_pixel_for_pixel(both):
    jax_values, port_values, _ = both
    grids = 0
    for (_, j), (_, p) in zip(jax_values, port_values):
        if p.image.encoded_image_string.startswith(b"\x89PNG"):
            assert (p.image.height, p.image.width, p.image.colorspace) == (
                j.image.height, j.image.width, j.image.colorspace)
            np.testing.assert_array_equal(_png(p), _png(j))
            grids += 1
    assert grids == 3


def test_gif_clips_within_the_colour_cube_of_the_tiled_frames(both):
    _, port_values, vids = both
    gifs = [(v.tag, v.image) for _, v in port_values
            if v.image.encoded_image_string.startswith(b"GIF89a")]
    assert [t for t, _ in gifs] == ["Video/Scale_2/Real",
                                    "Video/Scale_2/Fake_var"]
    for (_, image), clips in zip(gifs, (vids[:3], vids[:1])):
        clips = np.clip((clips + 1.0) / 2.0, 0, 1)
        ref = (tbx_utils._prepare_video(clips.transpose(0, 1, 4, 2, 3))
               * 255.0).astype(np.uint8)
        gif = Image.open(io.BytesIO(image.encoded_image_string))
        frames = []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(np.asarray(gif.convert("RGB")))
        assert len(frames) == ref.shape[0] == 4
        assert (image.height, image.width) == ref.shape[1:3]
        err = np.abs(np.stack(frames).astype(int) - ref.astype(int))
        assert err.max() <= 26


class _FakeNeptune:
    def __init__(self):
        self.metrics = []
        self.images = []

    def log_metric(self, tag, step, value):
        self.metrics.append((tag, step, value))

    def log_image(self, tag, step, y=None):
        self.images.append((tag, step, y.shape, y.dtype))


def test_neptune_routing(tmp_path):
    fake = _FakeNeptune()
    s = TensorboardSummary(str(tmp_path), neptune_exp=fake)
    s.add_scalar("Video/Scale 0/KLD", 1.25, 3)
    imgs = np.random.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    s.visualize_image(_cfg(0), 3, imgs, "Fake var")
    s.close()
    assert fake.metrics == [("Video/Scale 0/KLD", 3, 1.25)]
    (tag, step, shape, dtype), = fake.images
    assert tag == "Image/Scale 0/Fake var" and step == 3
    assert dtype == np.uint8 and shape[-1] == 3
    # either/or: nothing of them also lands in the event file
    assert _events(tmp_path) == []


def test_read_events_reads_what_tensorboard_reads(both, tmp_path):
    """The port's reader (for where TensorBoard is missing) against
    TensorBoard's, on the port's file."""
    _, port_values, _ = both
    s = TensorboardSummary(str(tmp_path))
    vids = np.random.default_rng(3).uniform(-1, 1, (2, 3, 6, 8, 3))
    s.add_scalar("Video/Scale 1/KLD", 2.5, 4)
    s.visualize_video(_cfg(1), 4, vids.astype(np.float32), "Real")
    s.close()
    path, = glob.glob(f"{tmp_path}/*tfevents*")
    events = tb_events.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], tag, kind, what) for e in events[1:]
           for tag, kind, what in e["values"]]
    want = []
    for step, v in _events(tmp_path):
        if v.WhichOneof("value") == "simple_value":
            want.append((step, v.tag, "scalar", v.simple_value))
        else:
            i = v.image
            want.append((step, v.tag, "image", (i.height, i.width,
                                                i.colorspace,
                                                i.encoded_image_string)))
    assert got == want and len(got) == 3
    with open(path, "r+b") as f:     # a flipped payload byte
        f.seek(-10, 2)
        byte = f.read(1)
        f.seek(-10, 2)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(ValueError, match="CRC"):
        tb_events.read_events(path)
