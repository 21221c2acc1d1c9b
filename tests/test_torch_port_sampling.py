"""The port's ``SamplerSession`` against the JAX session, on a tiny 3D run
that the JAX CLI trained from tests/assets/test_video.avi: the rand, rec
(from the dataset), inject and extrapolated (``h_factor=2``) batches equal
the JAX session's on the JAX draws; ``rec_input`` equals JAX's; and
``write_sample``'s AVI, read back by OpenCV, holds exactly the JAX
de-normalisation of the clip, on the JAX run and on the port's own."""
import glob
import os

import cv2
import jax
import numpy as np
import pytest

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.serving import SamplerSession as JSession
from hpvaegan_tpu.serving import apply_snapshot as japply_snapshot
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.utils.video_io import read_avi
from torch_port_runs import (make_clip, one_torch_thread, port_run,
                             shared_jax_run)

RTOL, ATOL = 2e-3, 2e-4
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    clip = make_clip(tmp_path_factory.mktemp("clip"))
    return {"jax": shared_jax_run(tmp_path_factory),
            "port": port_run(clip, tmp_path_factory.mktemp("prun"))}


def _port_session(exp, **kw):
    netG = os.path.join(exp, "netG")
    cfg = Config(netG=netG)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return SamplerSession(cfg, batch_size=BATCH, manual_seed=3,
                          device="cpu", **kw)


def _jax_session(exp, **kw):
    netG = os.path.join(exp, "netG")
    cfg = JConfig(netG=netG)
    japply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return JSession(cfg, batch_size=BATCH, manual_seed=3, **kw)


@pytest.fixture(scope="module")
def sessions(runs):
    exp = runs["jax"]
    return _jax_session(exp), _port_session(exp)


def _stage_noises(key, sess, start=0):
    """The JAX forward's draws: generators.py:174 splits off the
    reparameterization key, then each noisy stage from ``start`` splits
    once (:255-256).  Returns (k_rep, stage noises for the port)."""
    key, k_rep = jax.random.split(key)
    noises = []
    for idx in range(len(sess.G.body)):
        if idx >= start and sess.cfg.vae_levels <= idx + 1:
            key, k_n = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(
                k_n, (BATCH, *sess.pyramid.shape3d(idx + 1), 3))))
        else:
            noises.append(None)
    return k_rep, noises


def _rand_pair(jsess, psess, seed):
    noise = np.random.default_rng(seed).standard_normal(
        psess.noise_shape).astype(np.float32)
    assert tuple(jsess.noise_shape) == psess.noise_shape
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsess.sample_fn(jsess.gvars, noise, key))
    _, noises = _stage_noises(key, psess)
    return ref, psess.sample_batch(noise=noise, noises=noises)


def test_rand_batch_equals_jax(sessions):
    jsess, psess = sessions
    assert psess.scale == jsess.scale == 4
    np.testing.assert_allclose(psess.amps, np.asarray(jsess.amps),
                               rtol=1e-6)
    ref, out = _rand_pair(jsess, psess, 11)
    assert out.shape == (BATCH, *psess.pyramid.shape3d(4), 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_rec_input_equals_jax(sessions):
    jsess, psess = sessions
    (jzero, jcur), (pzero, pcur) = jsess.rec_input(), psess.rec_input()
    np.testing.assert_array_equal(pzero, np.asarray(jzero))
    np.testing.assert_array_equal(pcur, np.asarray(jcur))
    assert pzero.shape == (BATCH, *psess.pyramid.shape3d(0), 3)


def test_rec_batch_from_the_dataset_equals_jax(sessions):
    jsess, psess = sessions
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jsess.reconstruct_fn(jsess.gvars,
                                          jsess.rec_input()[0], key))
    k_rep, _ = _stage_noises(key, psess)
    eps = np.asarray(jax.random.normal(
        k_rep, (BATCH, *psess.pyramid.shape3d(0), psess.cfg.latent_dim)))
    out = psess.reconstruct_batch(eps=eps)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("start", [1, 3])
def test_inject_batch_equals_jax(sessions, start):
    jsess, psess = sessions
    jsess.dataset.generate_frames(start)
    cur, _ = jsess.dataset.get(0, hflip=False, scale_idx=start)
    np.testing.assert_array_equal(psess.real_clip(start), cur)
    x_init = np.stack([cur] * BATCH)
    key = jax.random.PRNGKey(13 + start)
    ref = np.asarray(jsess.inject_fn(jsess.gvars, x_init, key, start))
    _, noises = _stage_noises(key, psess, start)
    out = psess.inject_batch(x_init, start, noises=noises)
    assert out.shape == (BATCH, *psess.pyramid.shape3d(4), 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_extrapolated_batch_equals_jax(runs):
    exp = runs["jax"]
    jsess = _jax_session(exp, h_factor=2.0)
    psess = _port_session(exp, h_factor=2.0)
    base = psess.train_pyramid.shape3d(4)
    assert psess.pyramid.shape3d(4) == (base[0], 2 * base[1], base[2])
    ref, out = _rand_pair(jsess, psess, 14)
    assert out.shape == (BATCH, *psess.pyramid.shape3d(4), 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return np.stack(frames), fps


@pytest.mark.parametrize("which", ["jax", "port"])
def test_write_sample_is_the_exact_jax_denormalisation(runs, which,
                                                       tmp_path):
    psess = _port_session(runs[which])
    clip = psess.sample_batch()[0]
    path = psess.write_sample(clip, str(tmp_path / "s"))
    assert path == str(tmp_path / "s.avi")
    frames, fps = _cv2_frames(path)
    np.testing.assert_array_equal(frames,
                                  np.uint8((clip + 1.0) * 127.5)[..., ::-1])
    assert frames.shape == clip.shape
    assert fps == pytest.approx(psess.pyramid.fps(psess.scale))
    own, own_fps = read_avi(path)
    np.testing.assert_array_equal(own, frames[..., ::-1])
    assert own_fps == pytest.approx(fps)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_every_run_directory_has_an_events_file(runs, which):
    assert glob.glob(os.path.join(runs[which], "events.out.tfevents.*"))


def test_rand_sampling_needs_no_frames_file(runs, tmp_path):
    """Rand mode reads the geometry from config.json; rec mode opens the
    frames file, and raises naming the tool when it is gone."""
    psess = _port_session(runs["port"])
    psess.cfg.video_path = str(tmp_path / "gone.avi")
    assert not psess.has_frames()
    assert np.all(np.isfinite(psess.sample_batch()))
    psess.warmup(("rand", "rec"))   # rec on zeros without the frames
    with pytest.raises(FileNotFoundError, match="decode_frames"):
        psess.rec_input()
