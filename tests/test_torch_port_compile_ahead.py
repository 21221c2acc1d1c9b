"""``--compile-ahead`` in the port (``train/precompile.py``) on the CPU:
the next scale's state readied on a thread while a scale trains.

* the video and image CLIs end bit-equal to the runs without the flag
  (``netG``, ``netD_4``, the amps), on the device cache and the host
  loader, at ``--scan-steps`` 1 and 2, each later scale logging its
  ``ready`` line and none a ``failed`` one;
* the thread leaves scale ``s``'s state bit-equal (every parameter,
  buffer and optimizer state, the config, the dataset's frames), and
  adoption keeps every adopted tensor's address while it takes the grown
  generator's values, the critic's init and its warm start;
* ``full_f32()`` and ``deterministic()`` hold their flags while any of
  two threads is inside;
* the amps as an f32 tensor give the floats' bits through ``apply``,
  ``gan_step`` and ``vae_step``, in f32 and bf16;
* the skip rules, ``_predicted_n_amps`` and the chunk rule agree with the
  JAX module's;
* an out-of-memory error in the ahead warm-up publishes no rung and the
  run still ends bit-equal;
* over a 1x2 mesh of gloo ranks no collective runs on the thread;
* one worker thread serves every scale of every run in a process.
"""
import copy
import logging
import os
import re
import threading
import types

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from hpvaegan_tpu_torch import deterministic, full_f32
from hpvaegan_tpu_torch.cli import train_image, train_video
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.data.loader import make_loader
from hpvaegan_tpu_torch.data.video import SingleVideoDataset
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.train import optim, precompile, steps, trainer
from hpvaegan_tpu_torch.utils.logger import kept_logging
from hpvaegan_tpu_torch.utils.tools import seeded_generator
from torch_port_runs import (TINY, TINY_IMAGE, experiment, image_experiment,
                             make_clip, make_image, one_torch_thread)

RUNS = {"video": (train_video, "--video-path", TINY, experiment),
        "image": (train_image, "--image-path", TINY_IMAGE,
                  image_experiment)}
LOADERS = {"cache": [], "host": ["--host-loader"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    return {"video": make_clip(d), "image": make_image(d)}


def _run(kind, inputs, run_dir, *extra):
    cli, flag, tiny, exp_of = RUNS[kind]
    with kept_logging():
        cfg = cli.main([flag, inputs[kind], *tiny, "--run-dir",
                        str(run_dir), *extra])
    return cfg, exp_of(run_dir)


@pytest.fixture(scope="module")
def plain(inputs, tmp_path_factory):
    """The runs without the flag, made once a flag set."""
    made = {}

    def get(kind, *extra):
        key = (kind,) + extra
        if key not in made:
            made[key] = _run(kind, inputs, tmp_path_factory.mktemp(kind),
                             *extra)[1]
        return made[key]
    return get


def _load(exp, name):
    return torch.load(os.path.join(exp, name), map_location="cpu",
                      weights_only=True)


def _assert_same_run(exp, ref):
    for name, key in (("netG", "gvars"), ("netD_4", "dvars")):
        got, want = _load(exp, name)[key], _load(ref, name)[key]
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)
    assert _load(exp, "netG")["noise_amps"] == \
        _load(ref, "netG")["noise_amps"]


def _log(exp) -> str:
    with open(os.path.join(exp, "logbook.txt")) as f:
        return f.read()


@pytest.mark.parametrize("scan", ["1", "2"])
@pytest.mark.parametrize("loader", list(LOADERS))
@pytest.mark.parametrize("kind", list(RUNS))
def test_the_cli_ends_bit_equal_with_compile_ahead(kind, loader, scan,
                                                   inputs, plain, tmp_path):
    flags = LOADERS[loader] + ["--scan-steps", scan]
    _, exp = _run(kind, inputs, tmp_path, *flags, "--compile-ahead")
    _assert_same_run(exp, plain(kind, *flags))
    log = _log(exp)
    assert "failed" not in log
    for s in range(1, 5):
        assert len(re.findall(rf"compile-ahead scale {s}: state built in "
                              rf"[0-9.]+s, warmed up, ready in ", log)) == 1, s
    assert "nothing to do" not in log
    # one worker thread a process, whatever the number of scales and runs
    names = [t.name for t in threading.enumerate()]
    assert names.count("compile-ahead") == 1, names


# ---- the thread against the state of the scale it runs beside ----

SEED, SCALE = 5, 2          # scale 2 is a GAN scale (vae_levels 2)


def _scale_state(clip):
    """The CLI's state at ``SCALE`` after two steps: cfg, dataset, G,
    D, both Adams."""
    from hpvaegan_tpu_torch.core.config import build_parser, \
        config_from_args
    cfg = config_from_args(build_parser("video").parse_args(
        ["--video-path", clip, *TINY, "--compile-ahead"]))
    cfg.adjust_scales()
    cfg.scale_idx, cfg.resumed_idx = SCALE, -1
    ds = SingleVideoDataset(cfg)
    ds.generate_frames(SCALE)
    G = make_generator(cfg.generator, cfg, ds.pyramid, ndim=3)
    G.init(seeded_generator(SEED, 7))
    for s in range(1, SCALE + 1):
        G.init_next_stage(seeded_generator(SEED, 100 + s))
    cfg.Noise_Amps = [1.0, 0.3, 0.2]
    h0, w0 = ds.pyramid.shape2d(0)
    cfg.Z_init_size = [cfg.batch_size, cfg.td, h0, w0, cfg.latent_dim]
    D = make_discriminator(cfg.discriminator, cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    batches = make_loader(ds, cfg, SEED, SCALE, "cpu")
    step = trainer.scale_step(cfg, G, D, opt_g, opt_d, batches, True)
    amps = torch.tensor(cfg.Noise_Amps)
    for it in range(2):
        idxs, flips = batches.draw(1)
        source = dict(zip(("idx", "flip"), batches.rows(idxs[0], flips[0])))
        rz = batches.gather(source["idx"], source["flip"])[1]
        step(trainer.iteration_inputs(cfg, G, True, source, tuple(rz.shape),
                                      amps, seeded_generator(SEED, 9, it)))
    return cfg, ds, G, D, opt_g, opt_d


def _snapshot(cfg, ds, G, D, opt_g, opt_d) -> dict:
    tensors = {f"G.{k}": v.clone() for k, v in G.state_dict().items()}
    tensors.update({f"D.{k}": v.clone() for k, v in D.state_dict().items()})
    for name, opt in (("opt_g", opt_g), ("opt_d", opt_d)):
        for i, state in enumerate(opt.state.values()):
            for k, v in state.items():
                tensors[f"{name}.{i}.{k}"] = v.clone()
    fields = {k: copy.deepcopy(v) for k, v in vars(cfg).items()
              if not k.startswith("_")}
    return {"tensors": tensors, "cfg": fields, "frames": ds.frames.copy(),
            "frames_scale": ds._frames_scale,
            "requires_grad": [p.requires_grad for p in G.parameters()]}


@pytest.fixture(scope="module")
def ahead_case(inputs):
    """Scale ``SCALE``'s state, its snapshot, and scale ``SCALE + 1``
    readied beside it: built by the thread, warmed up here."""
    cfg, ds, G, D, opt_g, opt_d = _scale_state(inputs["video"])
    before = _snapshot(cfg, ds, G, D, opt_g, opt_d)
    precompile.start_ahead(cfg, G, ds, SCALE + 1, SEED)
    precompile.prime_ahead(cfg, wait=True)
    return dict(cfg=cfg, ds=ds, G=G, D=D, opt_g=opt_g, opt_d=opt_d,
                before=before)


def test_the_thread_leaves_the_running_scale_bit_equal(ahead_case):
    c = ahead_case
    after = _snapshot(c["cfg"], c["ds"], c["G"], c["D"], c["opt_g"],
                      c["opt_d"])
    before = c["before"]
    assert set(after["tensors"]) == set(before["tensors"])
    for k, v in before["tensors"].items():
        assert torch.equal(after["tensors"][k], v), k
    assert after["cfg"] == before["cfg"]
    assert np.array_equal(after["frames"], before["frames"])
    assert after["frames_scale"] == before["frames_scale"] == SCALE
    assert after["requires_grad"] == before["requires_grad"]
    state = c["cfg"]._ahead.state
    assert state is not None and state.scale_idx == SCALE + 1
    assert len(state.G.body) == SCALE + 1
    # the stores are the next scale's frames, made apart
    ds = c["ds"]
    assert tuple(state.loader._cur.shape[1:3]) == \
        ds.pyramid.shape2d(SCALE + 1)
    assert np.array_equal(state.loader._cur.numpy(),
                          ds._generate_frames(SCALE + 1))


def _ptrs(state) -> dict:
    out = {f"G.{k}": v.data_ptr() for k, v in state.G.state_dict().items()}
    out.update({f"D.{k}": v.data_ptr()
                for k, v in state.D.state_dict().items()})
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, st in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v.data_ptr()
                        for k, v in st.items()})
    return out


def test_adoption_keeps_every_address(ahead_case, tmp_path):
    c = ahead_case
    cfg, G = c["cfg"], c["G"]
    state = cfg._ahead.state
    ptrs = _ptrs(state)
    assert any(k.startswith("opt_g.") for k in ptrs)   # warmed up
    # the CLI's growth, then the boundary's adoption and warm start
    grown = copy.deepcopy(G)
    grown.init_next_stage(seeded_generator(SEED, 100 + SCALE + 1))
    cfg.scale_idx = SCALE + 1
    got = precompile.take_ahead(cfg, SCALE + 1, grown)
    assert got is state and cfg._ahead is None
    fresh = make_discriminator(cfg.discriminator, cfg, 3)
    fresh.reset_parameters(torch.Generator().manual_seed(
        SEED * 1000 + 101 + SCALE + 1))
    for k, v in fresh.state_dict().items():
        assert torch.equal(state.D.state_dict()[k], v), k
    path = str(tmp_path / f"netD_{SCALE}")
    torch.save({"dvars": c["D"].state_dict()}, path)
    trainer._warm_start(state.D, path)
    assert _ptrs(state) == ptrs
    assert state.G.cfg is cfg
    for k, v in grown.state_dict().items():
        assert torch.equal(state.G.state_dict()[k], v), k
    for k, v in c["D"].state_dict().items():
        assert torch.equal(state.D.state_dict()[k], v), k
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            assert all(not v.any() for v in st.values())


def test_the_stand_in_batches_have_the_loaders_shapes(inputs):
    """The host loader's stand-ins (zero batches of the pyramid's
    shapes) are shaped as the batches the scale then trains on."""
    from hpvaegan_tpu_torch.core.config import build_parser, \
        config_from_args
    cfg = config_from_args(build_parser("video").parse_args(
        ["--video-path", inputs["video"], *TINY, "--host-loader"]))
    cfg.adjust_scales()
    ds = SingleVideoDataset(cfg)
    G = make_generator(cfg.generator, cfg, ds.pyramid, ndim=3)
    for scale in (1, 4):
        ds.generate_frames(scale)
        cfg.scale_idx = scale
        cfg.Z_init_size = [2, 4, 6, 8, 8]
        stand = precompile._stand_in(cfg, G, False, None, scale, scale + 1,
                                     torch.device("cpu"))
        loader = make_loader(ds, cfg, SEED, scale, "cpu")
        try:
            real, real_zero = next(loader)
        finally:
            loader.close()
        assert stand["real"].shape == real.shape, scale
        assert stand["real_zero"].shape == real_zero.shape, scale


# ---- the flag contexts under two threads ----

def _flags():
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
            b.cudnn.deterministic)


@pytest.mark.parametrize("first_out", ["first_in", "second_in"])
@pytest.mark.parametrize("ctx", ["full_f32", "deterministic"])
def test_the_flag_contexts_hold_while_any_thread_is_inside(ctx, first_out):
    """Thread A enters, thread B enters, one leaves: the flags stay the
    block's until the other leaves too, then the old ones come back."""
    block = {"full_f32": full_f32, "deterministic": deterministic}[ctx]
    want = (False, False, False) if ctx == "full_f32" else (None, None,
                                                            True)
    old = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    outer = _flags()
    go = {n: threading.Event() for n in ("a_in", "b_in", "a_out", "b_out",
                                         "a_done", "b_done")}
    seen = {}

    def worker(name):
        with block():
            go[f"{name}_in"].set()
            go[f"{name}_out"].wait(10)
        seen[name] = _flags()
        go[f"{name}_done"].set()

    def inside(flags):
        return all(w is None or f == w for f, w in zip(flags, want))

    try:
        a = threading.Thread(target=worker, args=("a",))
        b = threading.Thread(target=worker, args=("b",))
        a.start()
        assert go["a_in"].wait(10)
        b.start()
        assert go["b_in"].wait(10)
        leave, stay = ("a", "b") if first_out == "first_in" else ("b", "a")
        go[f"{leave}_out"].set()
        assert go[f"{leave}_done"].wait(10)
        assert inside(seen[leave]) and inside(_flags())
        go[f"{stay}_out"].set()
        assert go[f"{stay}_done"].wait(10)
        a.join(10)
        b.join(10)
        assert seen[stay] == outer and _flags() == outer
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = old


# ---- the amps as a tensor ----

def _tiny_models(bf16: bool, scale: int):
    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=8, latent_dim=8,
                 num_layer=2, enc_blocks=1, vae_levels=2, bf16=bf16)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = scale
    gen = torch.Generator().manual_seed(0)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3).init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    D = make_discriminator(cfg.discriminator, cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    return cfg, G, D


AMPS = [1.0, 0.3141592653589793, 0.1234567891011, 0.0765432101]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("what", ["apply", "gan_step", "vae_step"])
def test_tensor_amps_give_the_floats_bits(what, bf16):
    scale = 3 if what != "vae_step" else 1
    cfg, G, D = _tiny_models(bf16, scale)
    pyr = cfg.pyramid()
    rng = np.random.default_rng(4)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    real = torch.tanh(draw(2, *pyr.shape3d(scale), 3))
    real_zero = torch.tanh(draw(2, *pyr.shape3d(0), 3))
    noise_init = draw(2, *pyr.shape3d(0), cfg.latent_dim)
    floats = AMPS[:scale + 1]
    tensor = torch.tensor(floats, dtype=torch.float32)

    def run(amps):
        g, d = copy.deepcopy(G), copy.deepcopy(D)
        gen = torch.Generator().manual_seed(3)
        if what == "apply":
            out = g.apply(amps, noise_init=noise_init, mode="rand",
                          train=True, generator=gen)[0]
            return [out], []
        opt_g = optim.build_g_optimizer(cfg, g, scale)
        if what == "vae_step":
            m = steps.vae_step(g, opt_g, cfg, real, real_zero, amps,
                               generator=gen)
        else:
            m = steps.gan_step(g, d, opt_g, optim.build_d_optimizer(cfg, d),
                               cfg, real, real_zero, noise_init, amps,
                               generator=gen)
        return list(m.values()), [*g.state_dict().values(),
                                  *d.state_dict().values()]

    (out_f, state_f), (out_t, state_t) = run(floats), run(tensor)
    for a, b in zip(out_f + state_f, out_t + state_t):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---- the rules shared with the JAX module ----

def _jax_precompile():
    from hpvaegan_tpu.train import precompile as jp
    return jp


@pytest.mark.parametrize("scan,niter,visualize,interval", [
    (1, 5, False, 100), (4, 5, False, 100), (4, 3, False, 100),
    (8, 20, True, 3), (8, 20, True, 0), (2, 1, True, 1), (0, 4, False, 5)])
def test_the_chunk_rule_is_the_jax_one(scan, niter, visualize, interval):
    cfg = types.SimpleNamespace(scan_steps=scan, niter=niter,
                                visualize=visualize,
                                print_interval=interval)
    assert precompile._chunk_k(cfg) == _jax_precompile()._chunk_k(cfg)


@pytest.mark.parametrize("n_amps,scale", [(0, 0), (1, 1), (3, 3), (5, 3),
                                          (4, 4), (2, 6)])
def test_the_predicted_amps_are_the_jax_ones(n_amps, scale):
    cfg = types.SimpleNamespace(Noise_Amps=[0.1] * n_amps)
    assert precompile._predicted_n_amps(cfg, scale) == \
        _jax_precompile()._predicted_n_amps(cfg, scale)


@pytest.mark.parametrize("scale,stop,resumed", [(5, 4, -1), (3, 4, 3),
                                                (2, 4, 1)])
def test_the_skip_rules_are_the_jax_ones(scale, stop, resumed,
                                         monkeypatch):
    """Past ``stop_scale`` and on the resumed scale no thread starts,
    where the JAX ``start_compile_ahead`` returns None too; otherwise
    both start one (the thread's work replaced by a no-op)."""
    jp = _jax_precompile()
    monkeypatch.setattr(jp, "_run", lambda *a: None)
    monkeypatch.setattr(precompile, "_run", lambda *a: None)
    cfg = types.SimpleNamespace(stop_scale=stop, resumed_idx=resumed,
                                Noise_Amps=[1.0], _ahead=None)
    G = types.SimpleNamespace(mesh=None, pyramid=None, ndim=3, body=[],
                              device=torch.device("cpu"))
    started = jp.start_compile_ahead(cfg, None, None, None, scale, 3)
    precompile.start_ahead(cfg, G, None, scale, 0)
    assert (started is not None) == (cfg._ahead is not None)
    assert (cfg._ahead is not None) == (scale <= stop and scale != resumed)


# ---- out of memory ahead ----

def test_an_oom_ahead_takes_no_rung_and_ends_bit_equal(inputs, plain,
                                                       tmp_path,
                                                       monkeypatch):
    from hpvaegan_tpu_torch.ops.kernels import _counting

    def gan_step(*args, **kwargs):
        if getattr(_counting._local, "apart", False):   # the warm-up ahead
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return steps.gan_step(*args, **kwargs)

    monkeypatch.setattr(trainer, "gan_step", gan_step)
    flags = ["--scan-steps", "1"]
    cfg, exp = _run("video", inputs, tmp_path, *flags, "--compile-ahead")
    _assert_same_run(exp, plain("video", *flags))
    assert not (cfg.remat or cfg.gp_chunked or cfg.remat_blocks)
    log = _log(exp)
    assert "enabling" not in log
    assert re.search(r"compile-ahead scale 1: state built in [0-9.]+s, "
                     r"warmed up", log)
    for s in (2, 3, 4):   # the GAN scales' warm-ups ran out of memory
        assert f"compile-ahead for scale {s} failed" in log
        assert f"compile-ahead scale {s}: state built in" not in log
    assert log.count("out of device memory beside scale") == 3


# ---- a mesh ----

def test_no_collective_runs_on_the_thread_over_a_mesh(inputs, tmp_path):
    """Both ranks of a 1x2 gloo mesh train the tiny video run with and
    without the flag: every collective runs on the main thread, the
    thread built every later scale, and the runs end bit-equal."""
    import shutil
    shutil.copy(inputs["video"], tmp_path / "test_video.avi")
    shutil.copy(inputs["video"][:-4] + ".frames.npz",
                tmp_path / "test_video.frames.npz")
    procs = ranks.start_ranks("ahead_mesh", 2, tmp_path)
    ranks.wait_ranks(procs, timeout=180)
    for out in ranks.results("ahead_mesh", 2, tmp_path):
        assert out["threads"] == ["MainThread"], out["threads"]
        assert out["collectives"] > 0
        for k, v in out["plain"].items():
            assert torch.equal(out["ahead"][k], v), k
    log = _log(experiment(tmp_path / "ahead"))
    assert "failed" not in log
    assert "--compile-ahead under a mesh" in log
    for s in range(1, 5):
        assert f"compile-ahead scale {s}: state built, ready in " in log


def test_the_baselines_cli_keeps_its_noop_line(caplog):
    """The baselines' trainer readies nothing ahead (neither does the JAX
    one): the flag is logged as a no-op there."""
    from hpvaegan_tpu_torch.cli import train_video_baselines
    caplog.set_level(logging.INFO)
    train_video_baselines.note_noop_flags(Config(compile_ahead=True))
    assert "--compile-ahead: accepted, nothing to do" in caplog.text
