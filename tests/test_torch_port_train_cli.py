"""The port's training entry point, ``hpvaegan_tpu_torch.cli.train_video``,
in-process with ``--no-cuda`` on the tiny configuration of
tests/test_train_video_e2e.py:11-33: the JAX e2e's file set and amps,
``config.json`` with the JAX snapshot's keys, ``--netG`` resume with
growth replay and the ``Z_init_size`` quirk, an exact ``netG_mid`` resume
(the property of tests/test_save_interval.py:67), every flag of the JAX
CLI training (none is left unported), ``--spmd`` or ``--mesh-shape`` alone
training in one process, and ``--distributed`` without a launcher
raising.  The sharded CLI runs are in test_torch_port_spmd_cli.py."""
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu_torch.cli import train_video
from hpvaegan_tpu_torch.tools.decode_frames import decode_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CLIP = os.path.join(REPO, "tests", "assets", "test_video.avi")
COMMON = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
          "--niter", "2", "--nfc", "8", "--num-layer", "2",
          "--batch-size", "2", "--manualSeed", "5", "--latent-dim", "8",
          "--enc-blocks", "1", "--no-cuda"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is faster, and it
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    path = str(d / "test_video.avi")
    shutil.copy(TEST_CLIP, path)
    decode_frames(path)
    return path


@pytest.fixture(autouse=True)
def _restore_logging():
    """The CLI replaces the root logger's handlers; give them back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


def _run(clip, run_dir, *extra, callback=None):
    argv = ["--video-path", clip, *COMMON, "--run-dir", str(run_dir),
            *extra]
    return train_video.main(argv, callback=callback)


def _exp(run_dir, n=0):
    return os.path.join(str(run_dir), "test_video", "DEBUG",
                        f"experiment_{n}")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _stages(gvars):
    return len({k.split(".")[1] for k in gvars if k.startswith("body.")})


@pytest.fixture(scope="module")
def first_run(clip, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("run")
    cfg = _run(clip, run_dir, "--vae-levels", "2")
    return run_dir, cfg


def test_cli_writes_the_jax_e2e_file_set(first_run):
    run_dir, cfg = first_run
    exp = _exp(run_dir)
    with open(os.path.join(exp, "Noise_Amps.json")) as f:
        amps = json.load(f)
    assert amps["scale"] == 4
    amps = amps["noise_amps"]
    assert len(amps) == 5 and amps[0] == 1.0
    assert all(np.isfinite(a) for a in amps)
    for name in ("netG", "netD_2", "netD_3", "netD_4", "Noise_Amps",
                 "config.json", "logbook.txt", "eval"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert not os.path.exists(os.path.join(exp, "netD_1"))  # VAE scale
    raw = _load(os.path.join(exp, "netG"))
    assert set(raw) == {"scale", "gvars", "noise_amps", "opt_g"}
    assert raw["scale"] == 4 and _stages(raw["gvars"]) == 4
    assert raw["noise_amps"] == amps
    assert set(_load(os.path.join(exp, "netD_4"))) == {"scale", "dvars",
                                                       "opt_d"}
    assert torch.equal(_load(os.path.join(exp, "Noise_Amps"))["data"],
                       torch.tensor(amps))
    # the quirk: the decoder latent has the td of the first scale trained
    assert cfg.Z_init_size == [2, cfg.pyramid().td(0), 6, 8, 8]


def test_config_json_has_the_jax_snapshot_keys(first_run):
    run_dir, cfg = first_run
    with open(os.path.join(_exp(run_dir), "config.json")) as f:
        snap = json.load(f)
    assert set(snap) == set(JConfig().snapshot_dict())
    assert snap["ar"] == 0.75 and snap["org_fps"] == 24.0
    assert snap["manualSeed"] == 5 and snap["stop_scale"] == 4


def test_netG_resume_replays_growth_and_keeps_the_amps(clip, first_run,
                                                      tmp_path):
    run_dir, _ = first_run
    netG = os.path.join(_exp(run_dir), "netG")
    cfg = _run(clip, tmp_path, "--vae-levels", "2", "--netG", netG)
    assert cfg.resumed_idx == 4
    # the quirk on resume: the td of the scale the resume trains first
    assert cfg.Z_init_size == [2, cfg.pyramid().td(4), 6, 8, 8]
    raw = _load(os.path.join(_exp(tmp_path), "netG"))
    assert raw["scale"] == 4 and _stages(raw["gvars"]) == 4
    assert len(raw["noise_amps"]) == 5   # re-appending would be 6
    # the earlier scales' amps come from the f32 Noise_Amps file
    np.testing.assert_array_equal(
        np.float32(raw["noise_amps"][:4]),
        np.float32(_load(netG)["noise_amps"][:4]))
    assert os.path.exists(os.path.join(_exp(tmp_path), "netD_4"))


def test_netG_resume_on_the_first_gan_scale_needs_its_previous_critic(
        clip, tmp_path):
    """A --vae-levels 2 run interrupted after scale 2, its first GAN scale,
    leaves an end-of-scale netG of scale 2.  A --netG resume retrains that
    scale and warm-starts its critic from netD_1 of the run resumed from,
    as the JAX trainer does (hpvaegan_tpu/train/trainer.py:111-113); the
    VAE scales 0 and 1 write no critic, so the resume raises
    FileNotFoundError naming netD_1 and the directory, as the JAX
    trainer's open() does, and trains no fresh critic in its place."""
    def stop(scale, event, it, info):
        if scale == 3 and event == "step" and it == 0:
            raise _Stop

    with pytest.raises(_Stop):
        _run(clip, tmp_path, "--vae-levels", "2", callback=stop)
    exp = _exp(tmp_path)
    assert _load(os.path.join(exp, "netG"))["scale"] == 2
    assert os.path.exists(os.path.join(exp, "netD_2"))
    assert not os.path.exists(os.path.join(exp, "netD_1"))
    with pytest.raises(FileNotFoundError) as err:
        _run(clip, tmp_path, "--vae-levels", "2", "--netG",
             os.path.join(exp, "netG"))
    assert err.value.filename == os.path.join(exp, "netD_1")
    assert "netD_1" in str(err.value) and exp in str(err.value)


def test_netG_mid_resume_ends_with_the_uninterrupted_weights(clip,
                                                             tmp_path):
    """Scale 1 is a GAN scale under --vae-levels 1, with the td of scale 0,
    so the Z_init_size quirk keeps the latent's shape across the resume.
    The interrupted run stops right after its netG_mid write there."""
    flags = ("--vae-levels", "1", "--save-interval", "1")
    _run(clip, tmp_path / "a", *flags)

    def stop(scale, event, it, info):
        if scale == 1 and event == "step" and it == 0:
            raise _Stop

    with pytest.raises(_Stop):
        _run(clip, tmp_path / "b", *flags, callback=stop)
    mid = os.path.join(_exp(tmp_path / "b"), "netG_mid")
    raw_mid = _load(mid)
    assert (raw_mid["scale"], raw_mid["iteration"]) == (1, 1)
    assert raw_mid["dvars"] and raw_mid["opt_d"]   # the critic of scale 1
    # the last end-of-scale netG of the interrupted run is scale 0's
    assert _load(os.path.join(_exp(tmp_path / "b"), "netG"))["scale"] == 0

    _run(clip, tmp_path / "b", *flags, "--netG", mid)
    a = _load(os.path.join(_exp(tmp_path / "a"), "netG"))
    c = _load(os.path.join(_exp(tmp_path / "b", 1), "netG"))
    assert c["scale"] == 4 and a["noise_amps"] == c["noise_amps"]
    assert len(c["noise_amps"]) == 5
    assert set(a["gvars"]) == set(c["gvars"])
    for k, v in a["gvars"].items():
        assert torch.equal(v, c["gvars"][k]), k
    d_a = _load(os.path.join(_exp(tmp_path / "a"), "netD_4"))["dvars"]
    d_c = _load(os.path.join(_exp(tmp_path / "b", 1), "netD_4"))["dvars"]
    for k, v in d_a.items():
        assert torch.equal(v, d_c[k]), k


@pytest.mark.parametrize("flag", [
    ["--scan-steps", "2"],
    ["--fast-grads"], ["--fused-forwards"], ["--hoist-prefix"], ["--remat"],
    ["--remat-blocks"], ["--gp-chunked"], ["--compile-ahead"], ["--wpack"]])
def test_unported_flags_raise_naming_their_roadmap_item(clip, tmp_path, flag):
    """No flag is left unported: the fast path's (ROADMAP Queue 1 item
    9), the memory ladder's (item 8), ``--compile-ahead`` (the next
    scale readied on a thread, ``train/precompile.py``) and ``--wpack``
    (the packed path, which the tiny pyramid stays under, W < 128) all
    train the tiny run to the JAX e2e's file set."""
    steps = []
    cfg = _run(clip, tmp_path, *flag,
               callback=lambda s, e, i, m: steps.append(s)
               if e == "step" else None)
    assert steps == [s for s in range(5) for _ in range(2)]
    exp = _exp(tmp_path)
    for name in ["netG", "Noise_Amps", "Noise_Amps.json", "config.json",
                 "logbook.txt", "eval"] + [
                     f"netD_{s}" for s in range(cfg.vae_levels, 5)]:
        assert os.path.exists(os.path.join(exp, name)), name
    raw = _load(os.path.join(exp, "netG"))
    assert raw["scale"] == 4 and len(raw["noise_amps"]) == 5
    assert all(torch.isfinite(v).all() for v in raw["gvars"].values())


@pytest.mark.parametrize("flag", [["--spmd"], ["--mesh-shape", "2x1"]])
def test_spmd_or_mesh_shape_alone_trains_in_one_process(clip, first_run,
                                                        tmp_path, flag):
    """As in the JAX trainer (``trainer.py:131``), a mesh needs both
    flags: either alone trains in this process (the callback sees every
    scale's steps) and writes the plain run's weights."""
    scales = set()
    _run(clip, tmp_path, "--vae-levels", "2", *flag,
         callback=lambda s, e, i, m: scales.add(s))
    assert scales == set(range(5))
    ref = _load(os.path.join(_exp(first_run[0]), "netG"))["gvars"]
    got = _load(os.path.join(_exp(tmp_path), "netG"))["gvars"]
    for k, v in ref.items():
        assert torch.equal(v, got[k]), k


def test_distributed_without_a_launcher_raises_naming_the_variables(
        clip, tmp_path, monkeypatch):
    for var in ("HPVAEGAN_COORDINATOR", "HPVAEGAN_NUM_PROCESSES",
                "HPVAEGAN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="HPVAEGAN_COORDINATOR.*"
                       "HPVAEGAN_NUM_PROCESSES.*HPVAEGAN_PROCESS_ID"):
        _run(clip, tmp_path, "--distributed")
    assert not os.path.exists(os.path.join(str(tmp_path), "test_video"))


def test_without_no_cuda_the_cli_needs_a_card(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    argv = ["--video-path", clip, *[a for a in COMMON if a != "--no-cuda"],
            "--run-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_video.main(argv)
