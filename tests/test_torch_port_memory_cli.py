"""The memory ladder's flags through the three training entry points of
the port on the CPU: ``cli.train_video``, ``cli.train_image`` and
``cli.train_video_baselines`` on their tiny configs with ``--remat
--gp-chunked --remat-blocks`` train to their end, within the step bar of
the same run without the flags (the rematerialised steps recompute bit
for bit; the per-sample penalty sums in another order, and each Adam
step may then move a parameter by up to ``2 * lr``), and the same under
``--spmd`` over two gloo ranks (``1x2``; the baselines over ``2x1``,
their VALID convs split no H) within the step bar of the one-process
run.  Every run ends with the file set and finite weights.

Under a mesh the automatic ladder (``train/fallback.py``) escalates only
together: an OOM injected on both ranks in the same step climbs one rung
on both, ending as the run on that rung from the start; an OOM on one
rank alone fails the run on both ranks within seconds (the agreement's
time limit), not a hang (``tests/torch_port_ranks.py``'s programs)."""
import logging
import os
import re
import shutil
import time

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from hpvaegan_tpu_torch.cli import train_image, train_video, \
    train_video_baselines
from hpvaegan_tpu_torch.utils.logger import kept_logging
from torch_port_runs import (TINY, TINY_IMAGE, experiment, image_experiment,
                             make_clip, make_image, one_torch_thread)

LADDER = ["--remat", "--gp-chunked", "--remat-blocks"]
TINY_BASELINES = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
                  "--niter", "2", "--nfc", "8", "--num-layer", "2",
                  "--batch-size", "2", "--manualSeed", "5", "--no-cuda"]
# the CLI, its flags, its mesh, the experiment directory of a run dir,
# and the Adam steps a generator parameter may take in the whole run
RUNS = {
    "video": (train_video, "--video-path", TINY, "1x2", experiment, 10),
    "image": (train_image, "--image-path", TINY_IMAGE, "1x2",
              image_experiment, 10),
    "baselines": (train_video_baselines, "--video-path", TINY_BASELINES,
                  "2x1", experiment, 10),
}
LR = 5e-4   # --lr-g and --lr-d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    return {"clip": make_clip(d), "image": make_image(d)}


def _run(kind, inputs, run_dir, *extra):
    cli, flag, tiny, _, exp_of, _ = RUNS[kind]
    path = inputs["image" if kind == "image" else "clip"]
    with kept_logging():
        cli.main([flag, path, *tiny, "--run-dir", str(run_dir), *extra])
    return exp_of(run_dir)


def _netG(exp):
    return torch.load(os.path.join(exp, "netG"), map_location="cpu",
                      weights_only=True)


@pytest.fixture(scope="module")
def plain_runs(inputs, tmp_path_factory):
    return {kind: _run(kind, inputs, tmp_path_factory.mktemp(kind))
            for kind in RUNS}


@pytest.fixture(scope="module")
def ladder_runs(inputs, tmp_path_factory):
    return {kind: _run(kind, inputs, tmp_path_factory.mktemp(kind + "_l"),
                       *LADDER) for kind in RUNS}


def _assert_within_step_bar(exp, ref_exp, steps):
    got, want = _netG(exp), _netG(ref_exp)
    assert got["scale"] == want["scale"] == 4
    assert len(got["noise_amps"]) == 5
    np.testing.assert_allclose(got["noise_amps"], want["noise_amps"],
                               rtol=2e-3)
    for name, v in want["gvars"].items():
        g = got["gvars"][name]
        assert torch.isfinite(g.float()).all(), name
        diff = float((g.float() - v.float()).abs().max())
        assert diff <= 2 * LR * steps + 2e-4, (name, diff)
    for name in ("Noise_Amps", "Noise_Amps.json", "config.json", "netD_4",
                 "logbook.txt"):
        assert os.path.exists(os.path.join(exp, name)), name


@pytest.mark.parametrize("kind", list(RUNS))
def test_the_ladder_flags_train_to_the_end(kind, plain_runs, ladder_runs):
    _assert_within_step_bar(ladder_runs[kind], plain_runs[kind],
                            RUNS[kind][5])


@pytest.mark.parametrize("kind", list(RUNS))
def test_the_ladder_flags_train_over_a_mesh(kind, inputs, ladder_runs,
                                            tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    exp = _run(kind, inputs, tmp_path, *LADDER, "--spmd", "--mesh-shape",
               RUNS[kind][3])
    with open(os.path.join(exp, "logbook.txt")) as f:
        assert "rank 0 of 2" in f.read()
    _assert_within_step_bar(exp, ladder_runs[kind], RUNS[kind][5])


def test_a_symmetric_oom_escalates_every_rank(tmp_path):
    procs = ranks.start_ranks("ladder_both", 2, tmp_path)
    ranks.wait_ranks(procs, timeout=120)
    for out in ranks.results("ladder_both", 2, tmp_path):
        assert out["rungs"] == (True, False, False)
        for name, v in out["ref"].items():
            assert torch.equal(out["state"][name], v), name


def test_a_one_rank_oom_fails_every_rank_without_a_hang(tmp_path):
    t0 = time.perf_counter()
    procs = ranks.start_ranks("ladder_one", 2, tmp_path)
    with pytest.raises(RuntimeError) as err:
        ranks.wait_ranks(procs, timeout=120)
    assert time.perf_counter() - t0 < 100
    assert all(p.returncode not in (0, None) for p in procs)
    assert "cannot climb the memory ladder together" in str(err.value)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("kind", ["video", "image"])
def test_compile_ahead_and_wpack_change_nothing(kind, inputs, plain_runs,
                                                tmp_path):
    """``--compile-ahead`` readies each next scale on a thread
    (``train/precompile.py``): every scale after the first logs its
    ``ready`` line and none a ``failed`` one.  ``--wpack`` runs the
    packed path (``models/packed.py``); neither is logged as a no-op.
    It packs only at W >= ``WPACK_MIN_W`` (128), which the tiny pyramid
    (W <= 16) stays under, so both runs end bit-equal to the one
    without them."""
    exp = _run(kind, inputs, tmp_path, "--compile-ahead", "--wpack")
    got, want = _netG(exp), _netG(plain_runs[kind])
    for name, v in want["gvars"].items():
        assert torch.equal(got["gvars"][name], v), name
    assert got["noise_amps"] == want["noise_amps"]
    with open(os.path.join(exp, "logbook.txt")) as f:
        log = f.read()
    for scale in range(1, 5):
        assert len(re.findall(rf"compile-ahead scale {scale}: state built "
                              rf"in [0-9.]+s, warmed up, ready in ",
                              log)) == 1, scale
    assert "failed" not in log
    assert "nothing to do" not in log
