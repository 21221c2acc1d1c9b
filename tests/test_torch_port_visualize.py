"""The training summaries and ``--profile-dir`` of the port's training
CLI, in-process with ``--no-cuda`` on the tiny run of
tests/test_torch_port_train_cli.py: ``--visualize --print-interval 1``
writes every step's scalars (the JAX trainer's tags and the step's
values) and every iteration's ten image values, and ends with the same
checkpoints, bit for bit, as the run without it, whose experiment
directory still holds an event file; ``--profile-dir`` writes a trace per
scale."""
import glob
import json
import os
from collections import Counter

import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import (
    RawEventFileLoader)
from tensorboard.compat.proto import event_pb2

from hpvaegan_tpu_torch.cli import train_video
from torch_port_runs import (TINY, kept_logging, make_clip,
                             one_torch_thread, port_run)

SCALES, VAE_LEVELS, NITER = 5, 2, 2
VAE_TAGS = ("noise_amp", "KLD", "Rec_VAE")
GAN_TAGS = ("noise_amp", "rec_loss", "errG", "errD_fake", "errD_real")
GRIDS = ("Real", "Generated", "Generated_VAE", "Fake_var", "Fake_VAE_var")
KEYS = {"KLD": "kl_loss", "Rec_VAE": "rec_vae_loss", "rec_loss": "rec_loss",
        "errG": "errG", "errD_fake": "errD_fake", "errD_real": "errD_real"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_clip(tmp_path_factory.mktemp("clip"))


@pytest.fixture(scope="module")
def visualized(clip, tmp_path_factory):
    """The run with --visualize --print-interval 1, and every step's
    metrics as its callback saw them."""
    run_dir = tmp_path_factory.mktemp("vis")
    steps, shown = {}, []

    def callback(scale, event, it, info):
        if event == "step":
            steps[(scale, it)] = {k: float(v) for k, v in info.items()}
        elif event == "visualize":
            shown.append((scale, it))
            assert info["seconds"] >= 0

    with kept_logging():
        cfg = train_video.main(["--video-path", clip, *TINY, "--run-dir",
                                str(run_dir), "--visualize",
                                "--print-interval", "1"], callback=callback)
    exp = os.path.join(str(run_dir), "test_video", "DEBUG", "experiment_0")
    return exp, steps, shown, cfg


def _values(exp):
    files = glob.glob(os.path.join(exp, "events.out.tfevents.*"))
    assert len(files) == 1, files
    events = [event_pb2.Event.FromString(raw)
              for raw in RawEventFileLoader(files[0]).Load()]
    assert events[0].file_version == "brain.Event:2"
    return [(e.step, v) for e in events[1:] for v in e.summary.value]


def test_every_step_writes_the_jax_scalars(visualized):
    exp, steps, _, cfg = visualized
    assert len(steps) == SCALES * NITER
    scalars = {(v.tag, s): v.simple_value for s, v in _values(exp)
               if v.WhichOneof("value") == "simple_value"}
    want = {}
    for (scale, it), metrics in steps.items():
        tags = GAN_TAGS if scale >= VAE_LEVELS else VAE_TAGS
        for name in tags:
            value = (cfg.Noise_Amps[scale] if name == "noise_amp"
                     else metrics[KEYS[name]])
            want[(f"Video/Scale_{scale}/{name}", it)] = float(
                torch.tensor(value, dtype=torch.float32))
    assert scalars == want


def test_every_iteration_writes_the_ten_image_values(visualized):
    exp, _, shown, _ = visualized
    assert shown == [(s, i) for s in range(SCALES) for i in range(NITER)]
    images = Counter((v.tag, s) for s, v in _values(exp)
                     if v.WhichOneof("value") == "image")
    want = Counter((f"Video/Scale_{scale}/{g}{sfx}", it)
                   for scale in range(SCALES) for it in range(NITER)
                   for g in GRIDS for sfx in ("", "_unfold"))
    assert images == want
    for s, v in _values(exp):
        if v.WhichOneof("value") == "image":
            magic = v.image.encoded_image_string[:6]
            assert magic == (b"\x89PNG\r\n" if v.tag.endswith("_unfold")
                             else b"GIF89a")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_visualize_leaves_the_checkpoints_bit_identical(visualized, clip,
                                                         tmp_path):
    exp, *_ = visualized
    plain = port_run(clip, tmp_path)
    for name in ["netG", "Noise_Amps"] + [f"netD_{s}" for s in
                                          range(VAE_LEVELS, SCALES)]:
        _assert_equal(_load(os.path.join(exp, name)),
                      _load(os.path.join(plain, name)), name)
    # without --visualize the run still opens its event file, empty
    assert _values(plain) == []


def test_profile_dir_writes_a_trace_per_scale(clip, tmp_path):
    prof = tmp_path / "prof"
    port_run(clip, tmp_path / "run", "--niter", "6", "--profile-dir",
             str(prof))
    assert sorted(os.listdir(prof)) == [f"scale_{s}" for s in range(SCALES)]
    for s in range(SCALES):
        with open(prof / f"scale_{s}" / "trace.json") as f:
            trace = json.load(f)
        assert trace["traceEvents"]
