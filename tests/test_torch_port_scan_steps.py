"""``--scan-steps K`` through the port's trainer on the CPU (the chunk
semantics of JAX ``train/trainer.py:211, 268-403``; on the card the same
chunks replay a CUDA graph, ``tests/test_torch_port_gpu.py`` and
``chip_smoke.py`` phase 14).

Held on the tiny CLI run: ``--scan-steps 3 --niter 7 --visualize
--print-interval 2 --save-interval 2`` runs chunks cut at the print
boundaries (2, 2, 2 and a ragged 1), writes every iteration's scalars at
its true index and the image grids at each boundary, and writes
``netG_mid`` where the JAX trainer writes it (a chunk crossing a
``--save-interval`` multiple, not at the scale's end); a run stopped
after a ``netG_mid`` write and resumed from it ends bit-equal to the
uninterrupted chunked run.  ``--host-loader --scan-steps 3`` (the
calibration batch the first chunk's first) ends bit-equal to
``--scan-steps 1``.  The draws the trainer makes ahead of a step
(``steps.gan_draws``, ``G.draw_eps``) fed to the step give the step that
draws them itself, bit for bit."""
import copy
import logging
import os
import re
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch.cli import train_video
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.tools.decode_frames import decode_frames
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import saver as saver_mod
from hpvaegan_tpu_torch.utils.tb_events import read_events
from torch_port_runs import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
       "--niter", "7", "--nfc", "8", "--num-layer", "2", "--batch-size",
       "2", "--manualSeed", "5", "--latent-dim", "8", "--enc-blocks", "1",
       "--no-cuda"]
CHUNKED = ["--vae-levels", "1", "--scan-steps", "3", "--visualize",
           "--print-interval", "2", "--save-interval", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


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


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    path = str(d / "test_video.avi")
    shutil.copy(os.path.join(REPO, "tests", "assets", "test_video.avi"),
                path)
    decode_frames(path)
    return path


class _Stop(Exception):
    pass


def _run(clip, run_dir, *extra, callback=None):
    return train_video.main(["--video-path", clip, *CLI, "--run-dir",
                             str(run_dir), *extra], callback=callback)


def _exp(run_dir, n=0):
    return os.path.join(str(run_dir), "test_video", "DEBUG",
                        f"experiment_{n}")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_bit_equal(a_dir, b_dir, names=("netG", "netD_4")):
    for name in names:
        key = "gvars" if name == "netG" else "dvars"
        a = _load(os.path.join(a_dir, name))[key]
        b = _load(os.path.join(b_dir, name))[key]
        assert set(a) == set(b)
        for k, v in a.items():
            assert torch.equal(v, b[k]), (name, k)


def _jax_chunks(niter, scan, print_interval, save_interval, start=0):
    """The JAX trainer's chunks and netG_mid writes (trainer.py:270-276,
    366-368): ``k = min(K, niter - it)`` cut at the print boundaries under
    --visualize; a write at ``it + k`` when the chunk crosses a
    save-interval multiple before the scale's end."""
    chunks, saves, it = [], [], start
    while it < niter:
        k = min(scan, niter - it)
        boundary = (it // print_interval + 1) * print_interval
        k = max(1, min(k, boundary - it))
        chunks.append(k)
        if it + k < niter and (it + k) // save_interval > \
                it // save_interval:
            saves.append(it + k)
        it += k
    return chunks, saves


@pytest.fixture(scope="module")
def chunked_run(clip, tmp_path_factory):
    """The uninterrupted chunked run, its chunk events and netG_mid
    writes per scale."""
    run_dir = tmp_path_factory.mktemp("chunked")
    chunks, saves = {}, {}
    save = saver_mod.Saver.save_checkpoint

    def record(self, state, filename, *args, **kw):
        if filename == "netG_mid":
            saves.setdefault(state["scale"], []).append(state["iteration"])
        return save(self, state, filename, *args, **kw)

    def on_event(scale, event, it, info):
        if event == "chunk":
            chunks.setdefault(scale, []).append(info["k"])

    saver_mod.Saver.save_checkpoint = record
    try:
        cfg = _run(clip, run_dir, *CHUNKED, callback=on_event)
    finally:
        saver_mod.Saver.save_checkpoint = save
    return run_dir, cfg, chunks, saves


def test_chunks_scalars_and_netG_mid_follow_the_jax_trainer(chunked_run):
    run_dir, cfg, chunks, saves = chunked_run
    want_chunks, want_saves = _jax_chunks(7, 3, 2, 2)
    assert want_chunks == [2, 2, 2, 1] and want_saves == [2, 4, 6]
    assert chunks == {s: want_chunks for s in range(5)}
    assert saves == {s: want_saves for s in range(5)}
    exp = _exp(run_dir)
    events = read_events(next(os.path.join(exp, n) for n in os.listdir(exp)
                              if n.startswith("events.out.tfevents.")))
    scalars, images = Counter(), Counter()
    for e in events:
        for tag, kind, _ in e["values"]:
            scale = int(re.search(r"Scale[ _](\d+)", tag).group(1))
            (scalars if kind == "scalar" else images)[(scale, e["step"])] \
                += 1
    # every iteration's scalars at its true index: noise_amp and KLD, Rec
    # VAE at the VAE scale 0, the four GAN scalars from scale 1 on
    assert scalars == Counter({(s, it): 3 if s < cfg.vae_levels else 5
                               for s in range(5) for it in range(7)})
    assert set(images) == {(s, it) for s in range(5) for it in (0, 2, 4, 6)}


def test_a_netG_mid_resume_continues_the_chunked_run(clip, chunked_run,
                                                     tmp_path):
    """Stopped after the chunk [0, 2) of scale 1 wrote netG_mid at
    iteration 2 (scale 1 has scale 0's T, so the Z_init_size quirk keeps
    the latent across the resume), then resumed from it."""
    def stop(scale, event, it, info):
        if scale == 1 and event == "step" and it == 1:
            raise _Stop

    with pytest.raises(_Stop):
        _run(clip, tmp_path, *CHUNKED, callback=stop)
    mid = os.path.join(_exp(tmp_path), "netG_mid")
    raw = _load(mid)
    assert (raw["scale"], raw["iteration"]) == (1, 2)
    chunks = []
    _run(clip, tmp_path, *CHUNKED, "--netG", mid,
         callback=lambda s, e, i, m: chunks.append((s, m["k"]))
         if e == "chunk" else None)
    assert [k for s, k in chunks if s == 1] == \
        _jax_chunks(7, 3, 2, 2, start=2)[0] == [2, 2, 1]
    _assert_bit_equal(_exp(chunked_run[0]), _exp(tmp_path, 1))


def test_host_loader_chunks_consume_the_k1_batches(clip, tmp_path):
    flags = ["--vae-levels", "2", "--host-loader"]
    _run(clip, tmp_path / "k3", *flags, "--scan-steps", "3")
    _run(clip, tmp_path / "k1", *flags, "--scan-steps", "1")
    _assert_bit_equal(_exp(tmp_path / "k3"), _exp(tmp_path / "k1"))


@pytest.mark.parametrize("name", ["GeneratorHPVAEGAN", "GeneratorVAE_nb"])
def test_draws_made_ahead_equal_the_step_drawing_them(name):
    scale = 3
    cfg = fast.cfg_of(Config, generator=name)
    G = make_generator(name, cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    _, _, port_critic = fast.critics(3)
    real, real_zero, noise_init = fast.data(cfg.pyramid(), 3, scale, 61)
    amps = fast.AMPS
    runs = []
    for ahead in (False, True):
        g, d = copy.deepcopy(G), port_critic()
        draw = torch.Generator().manual_seed(62)
        kw = (steps.gan_draws(G, torch.as_tensor(noise_init),
                              real_zero.shape, generator=draw)
              if ahead else {"generator": draw})
        m = steps.gan_step(g, d, optim.build_g_optimizer(cfg, g, scale),
                           optim.build_d_optimizer(cfg, d), cfg, real,
                           real_zero, noise_init, amps, **kw)
        draw = torch.Generator().manual_seed(63)
        kw = ({"eps": G.draw_eps(real_zero.shape, draw)} if ahead
              else {"generator": draw})
        cfg.scale_idx = scale
        m.update({f"vae_{k}": v for k, v in steps.vae_step(
            g, optim.build_g_optimizer(cfg, g, scale), cfg, real, real_zero,
            amps, **kw).items()})
        runs.append((m, g, d))
    (m_a, g_a, d_a), (m_b, g_b, d_b) = runs
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for a, b in zip(list(g_a.state_dict().values())
                    + list(d_a.state_dict().values()),
                    list(g_b.state_dict().values())
                    + list(d_b.state_dict().values())):
        assert torch.equal(a, b)
    assert np.isfinite(float(m_a["loss"]))


def test_resize_matrices_for_the_card_are_kept_and_trainable():
    """A replayed step may not copy from host memory, so each resize
    matrix is uploaded once a device (``ops/resize.py``); one first asked
    for while sampling (``inference_mode``) must still serve a training
    step's backward.  Run here on the CPU device of the same cache."""
    from hpvaegan_tpu_torch.ops import resize
    with torch.inference_mode():
        m = resize._on_device(4, 7, torch.float32, torch.device("cpu"))
    assert not m.is_inference()
    assert resize._on_device(4, 7, torch.float32, torch.device("cpu")) is m
    np.testing.assert_array_equal(m.numpy(), resize._interp_matrix_np(4, 7))
    x = torch.randn(2, 4, requires_grad=True)
    (x @ m.T).sum().backward()
    assert x.grad is not None
