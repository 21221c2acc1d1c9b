"""The sharded training entry point on gloo CPU ranks: ``python -m
hpvaegan_tpu_torch.cli.train_video --spmd --mesh-shape 1x2 --no-cuda``,
once with ``--distributed`` and the launcher's environment (two processes
started here) and once in the local-spawn form (the CLI starts its two
ranks), on a three-scale pyramid (H = 9, 10, 12 rows: 9 is uneven over
the 2-way spatial axis; scale 0 a VAE scale, scales 1 and 2 GAN scales,
so scale 2's critic warm-starts from rank 0's netD_1), nfc 64 under
``--pconv --pconv-all``, so the stage convs run K4.  The counterpart of
tests/test_multihost.py:75-150: the run writes the single-process run's
files, only rank 0 writes, and the weights match the single-process
run's within the step bar (each Adam step moves a parameter by about
``lr``, so two runs whose gradients differ by rounding may part by up to
``2 * lr`` a step: 6 generator steps, 4 critic steps).  Under
``--visualize`` every rank samples and rank 0 writes grids of the whole
batch and the whole H, as the single-process run does."""
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.cli import train_video
from hpvaegan_tpu_torch.parallel.launch import free_port
from hpvaegan_tpu_torch.tools.decode_frames import decode_frames
from hpvaegan_tpu_torch.utils.tb_events import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--img-size", "16", "--min-size", "12", "--max-size", "16",
        "--niter", "2", "--nfc", "64", "--num-layer", "2", "--latent-dim",
        "8", "--enc-blocks", "1", "--vae-levels", "1", "--batch-size", "2",
        "--manualSeed", "5", "--no-cuda", "--pconv", "--pconv-all"]
SHARDED = ["--spmd", "--mesh-shape", "1x2"]
FILES = {"netG", "netD_1", "netD_2", "Noise_Amps", "Noise_Amps.json",
         "config.json", "logbook.txt", "eval"}
G_STEPS, D_STEPS = 6, 4


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    path = str(d / "test_video.avi")
    shutil.copy(os.path.join(REPO, "tests", "assets", "test_video.avi"),
                path)
    decode_frames(path)
    return path


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True)
def _restore_logging():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


def _exp(run_dir):
    return os.path.join(str(run_dir), "test_video", "DEBUG", "experiment_0")


def _load(run_dir, name):
    return torch.load(os.path.join(_exp(run_dir), name), map_location="cpu",
                      weights_only=True)


@pytest.fixture(scope="module")
def single(clip, tmp_path_factory):
    """The single-process run of the same flags and seed."""
    run_dir = tmp_path_factory.mktemp("single")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_video.main(["--video-path", clip, *ARGS, "--visualize",
                          "--run-dir", str(run_dir)])
    finally:
        torch.set_num_threads(threads)
    return run_dir


def _images(run_dir):
    """{tag: (height, width)} of the image values in the run's event
    file."""
    exp = _exp(run_dir)
    (name,) = [n for n in os.listdir(exp) if n.startswith("events.out")]
    return {tag: value[:2] for e in read_events(os.path.join(exp, name))
            for tag, kind, value in e.get("values", []) if kind == "image"}


def _assert_like_single(run_dir, single_dir):
    exp = _exp(run_dir)
    names = set(os.listdir(exp))
    events = [n for n in names if n.startswith("events.out.tfevents")]
    assert names - set(events) == FILES and len(events) == 1, names
    assert os.listdir(os.path.dirname(exp)) == ["experiment_0"]
    with open(os.path.join(exp, "logbook.txt")) as f:
        log = f.read()
    # rank 0's logbook alone: rank 1 logs to its console only
    assert "rank 0 of 2" in log and "rank 1 of 2" not in log
    assert "backend gloo" in log
    lr = 5e-4   # --lr-g, --lr-d defaults
    a, b = _load(single_dir, "netG"), _load(run_dir, "netG")
    np.testing.assert_allclose(b["noise_amps"], a["noise_amps"], rtol=2e-3)
    for key, steps, raw_a, raw_b in (
            ("gvars", G_STEPS, a, b),
            ("dvars", D_STEPS, _load(single_dir, "netD_2"),
             _load(run_dir, "netD_2"))):
        assert set(raw_a[key]) == set(raw_b[key])
        for name, v in raw_a[key].items():
            diff = float((v.float() - raw_b[key][name].float()).abs().max())
            assert diff <= 2 * lr * steps + 2e-4, (key, name, diff)
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["manualSeed"] == 5


def test_distributed_ranks_from_the_launcher_environment(clip, single,
                                                         tmp_path):
    coordinator = f"127.0.0.1:{free_port()}"
    argv = [sys.executable, "-m", "hpvaegan_tpu_torch.cli.train_video",
            "--video-path", clip, *ARGS, *SHARDED, "--distributed",
            "--run-dir", str(tmp_path)]
    procs = [subprocess.Popen(argv, cwd=REPO, env=dict(
        os.environ, HPVAEGAN_COORDINATOR=coordinator,
        HPVAEGAN_NUM_PROCESSES="2", HPVAEGAN_PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert "backend gloo" in outs[1]   # every rank says how it talks
    _assert_like_single(tmp_path, single)


def test_local_spawn_starts_the_mesh_ranks(clip, single, tmp_path):
    cfg = train_video.main(["--video-path", clip, *ARGS, *SHARDED,
                            "--visualize", "--run-dir", str(tmp_path)])
    assert cfg.spmd and cfg.mesh_shape == "1x2"
    _assert_like_single(tmp_path, single)
    want = _images(single)
    assert len(want) == 30 and _images(tmp_path) == want   # 10 a scale


def test_a_local_mesh_larger_than_the_cards_raises(monkeypatch):
    """The local launch starts one rank a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 positions and this host 1"):
        train_video.spawn_ranks(["--spmd", "--mesh-shape", "1x2"], 2,
                                no_cuda=False)
