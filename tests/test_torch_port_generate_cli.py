"""The port's ``python -m hpvaegan_tpu_torch.cli.generate``, in-process
with ``--no-cuda``, on the tiny 3D run that the JAX CLI trained and on
the port's own: the 3D counterparts of tests/test_generate_cli.py (rand
samples distinct, rec with ``--metrics``, ``--inject-scale`` and its range
check, ``--h-factor``, the snapshot alone, an explicit flag winning over
it, a missing checkpoint), ``--svfid``, ``--sifid`` and ``--image-path``
running (``--mesh-shape``: tests/test_torch_port_mesh_cli.py), the card required without ``--no-cuda``, and the parser equal
to the JAX CLI's."""
import logging
import os
import re

import cv2
import numpy as np
import pytest
import torch

import hpvaegan_tpu.eval as je
from hpvaegan_tpu.cli import generate as jgenerate
from hpvaegan_tpu_torch.cli import generate
from hpvaegan_tpu_torch.eval import diversity_score, reconstruction_psnr
from hpvaegan_tpu_torch.utils.video_io import to_uint8
from torch_port_runs import (make_clip, make_image, one_torch_thread,
                             port_image_run, port_run, shared_jax_run)

TOP = (13, 12, 16)      # (T, H, W) of the tiny runs' top scale, scale 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    clip = make_clip(tmp_path_factory.mktemp("clip"))
    return {"jax": os.path.join(shared_jax_run(tmp_path_factory), "netG"),
            "port": os.path.join(port_run(
                clip, tmp_path_factory.mktemp("prun")), "netG")}


def _gen(netG, out, *extra):
    return generate.main(["--netG", netG, "--no-cuda", "--output-dir",
                          str(out), "--batch-size", "2", *extra])


def _frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames)


def _logged(caplog, pattern):
    found = [m for r in caplog.records
             for m in [re.search(pattern, r.getMessage())] if m]
    assert len(found) == 1, [r.getMessage() for r in caplog.records]
    return found[0].group(1)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_rand_samples(runs, which, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    res = _gen(runs[which], tmp_path, "--num-samples", "3", "--metrics")
    assert res["paths"] == [str(tmp_path / f"sample_{i}.avi")
                            for i in range(3)]
    assert len(res["batch_ms"]) == 2 and len(res["write_ms"]) == 3
    frames = [_frames(p) for p in res["paths"]]
    for f, s in zip(frames, res["samples"]):
        assert f.shape == (*TOP, 3)
        np.testing.assert_array_equal(f, to_uint8(s))
    # independent noise -> distinct samples, batches included
    assert np.abs(frames[0].astype(int) - frames[2].astype(int)).mean() > 0
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).mean() > 0
    val = diversity_score(res["samples"])
    assert _logged(caplog, r"sample diversity \(mean pairwise L1\): "
                           r"([0-9.]+)$") == f"{val:.4f}"


@pytest.mark.parametrize("which", ["jax", "port"])
def test_rec_mode_and_its_psnr(runs, which, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    res = _gen(runs[which], tmp_path, "--mode", "rec", "--num-samples", "2",
               "--metrics")
    assert [os.path.basename(p) for p in res["paths"]] == ["sample_0.avi",
                                                          "sample_1.avi"]
    for path, s in zip(res["paths"], res["samples"]):
        np.testing.assert_array_equal(_frames(path), to_uint8(s))
    sess = generate.open_session(
        generate.build_parser().parse_args(["--netG", runs[which],
                                            "--no-cuda"]),
        generate.build_parser, ["--netG", runs[which], "--no-cuda"])
    real = sess.rec_input()[1]
    val = reconstruction_psnr(res["samples"], np.stack([real] * 2))
    assert np.isfinite(val)
    assert _logged(caplog, r"reconstruction PSNR: ([0-9.]+) dB$") == \
        f"{val:.2f}"


@pytest.mark.parametrize("which", ["jax", "port"])
def test_inject_scale(runs, which, tmp_path):
    """The sample_init injection hook (networks_3d.py:368-380)."""
    res = _gen(runs[which], tmp_path, "--inject-scale", "1",
               "--num-samples", "3", "--metrics")
    assert [os.path.basename(p) for p in res["paths"]] == [
        "inject_0.avi", "inject_1.avi", "inject_2.avi"]
    assert all(_frames(p).shape == (*TOP, 3) for p in res["paths"])
    assert np.all(np.isfinite(res["samples"]))


@pytest.mark.parametrize("which", ["jax", "port"])
def test_inject_scale_out_of_range(runs, which, tmp_path):
    with pytest.raises(ValueError, match=r"--inject-scale 4 out of range: "
                       r"checkpoint was trained to scale 4 with 4 body "
                       r"stages"):
        _gen(runs[which], tmp_path, "--inject-scale", "4")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_spatial_extrapolation(runs, which, tmp_path):
    res = _gen(runs[which], tmp_path, "--num-samples", "1", "--h-factor",
               "2.0", "--w-factor", "1.5")
    assert _frames(res["paths"][0]).shape == (TOP[0], 24, 24, 3)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_config_snapshot_alone_suffices(runs, which, tmp_path):
    res = generate.main(["--netG", runs[which], "--no-cuda", "--output-dir",
                         str(tmp_path), "--num-samples", "2"])
    assert [_frames(p).shape for p in res["paths"]] == [(*TOP, 3)] * 2


@pytest.mark.parametrize("which", ["jax", "port"])
def test_config_snapshot_cli_override(runs, which, tmp_path):
    """An explicit flag wins over the snapshot: a wider model than the
    one trained cannot load the checkpoint."""
    res = _gen(runs[which], tmp_path, "--num-samples", "1", "--t-factor",
               "2.0")
    assert _frames(res["paths"][0]).shape == (2 * TOP[0], *TOP[1:], 3)
    # load_state_dict's RuntimeError (port file), convert's ValueError
    # (JAX file)
    with pytest.raises((RuntimeError, ValueError),
                       match="size mismatch|shape mismatch"):
        _gen(runs[which], tmp_path, "--nfc", "16")


def test_missing_checkpoint_fails(runs, tmp_path):
    with pytest.raises(RuntimeError, match="no <G> checkpoint"):
        _gen("/does/not/exist", tmp_path, "--video-path", "clip.avi")


@pytest.fixture(scope="module")
def image_run(tmp_path_factory):
    image = make_image(tmp_path_factory.mktemp("image"))
    return image, os.path.join(port_image_run(
        image, tmp_path_factory.mktemp("irun")), "netG")


@pytest.mark.parametrize("flag", ["--svfid", "--sifid", "--image-path"])
def test_eval_and_image_flags_run(runs, image_run, tmp_path, caplog, flag):
    """The flags that raised before eval and the 2D path were ported:
    ``--svfid`` scores the 3D samples (the JAX CLI's log line, the JAX
    package's SVFID of the same samples), ``--sifid`` the 2D ones, and
    ``--image-path`` samples a 2D run into PNGs."""
    caplog.set_level(logging.INFO)
    image, netG = image_run
    if flag == "--svfid":
        res = _gen(runs["port"], tmp_path, "--svfid", "--num-samples", "2")
        line = (r"SVFID\[conv3b\] \(RANDOM C3D — relative only\): mean "
                r"([0-9.]+)  per-sample \[")
        real = generate.open_session(generate.build_parser().parse_args(
            ["--netG", runs["port"], "--no-cuda"]), generate.build_parser,
            ["--netG", runs["port"], "--no-cuda"]).real_clip(4)
        want = je.svfid(real, list(res["samples"]))
    elif flag == "--sifid":
        res = _gen(netG, tmp_path, "--sifid", "--image-path", image,
                   "--num-samples", "2")
        line = (r"SIFID\[pool1\] \(RANDOM stem — relative only\): mean "
                r"([0-9.]+)  per-sample \[")
        want = None
    else:
        res = _gen(netG, tmp_path, "--image-path", image, "--num-samples",
                   "3")
        assert res["paths"] == [str(tmp_path / f"sample_{i}.png")
                                for i in range(3)]
        assert res["samples"].shape == (3, 16, 16, 3)
        return
    value = float(_logged(caplog, line))
    got = res["metrics"][flag[2:]]
    assert got["pretrained"] is False and len(got["per_sample"]) == 2
    assert value == pytest.approx(got["mean"], abs=1e-4) and value > 0
    if want is not None:
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-4)


def test_without_no_cuda_the_cli_needs_a_card(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would sample on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--netG", runs["port"], "--output-dir",
                       str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, a.required, a.const, type(a).__name__)
            for a in parser._actions}


def test_parser_equals_the_jax_parser():
    got, want = _actions(generate.build_parser()), _actions(
        jgenerate.build_parser())
    assert got == want
    assert "--c3d-weights" in str(got) and "--sifid-layer" in str(got)
