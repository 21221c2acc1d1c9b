"""The baselines' entry point and the new generators' checkpoints through
the port on the CPU (``--no-cuda``): ``python -m
hpvaegan_tpu_torch.cli.train_video_baselines`` (its file set with
``Z_init``; a ``--netG`` resume that reloads ``Z_init`` and warm-starts
the critic from the run resumed from; a ``netG_mid`` resume that ends
with the uninterrupted run's weights bit for bit), ``cli.train_video
--generator GeneratorVAE_nb`` (train and resume), a baseline
``--inject-scale`` that raises as the JAX CLI's does, and the JAX
package's checkpoints of a baseline and of a ``GeneratorVAE_nb`` sampled
by the port's ``SamplerSession`` equal to the JAX session on the same
draws.

Those JAX checkpoints are written by the JAX package's own serializer
(``flax.serialization.to_bytes``, as ``hpvaegan_tpu/utils/saver.py``
writes ``netG``, ``Noise_Amps`` and ``Z_init``) with its
``config.json`` snapshot, from seeded weights: a JAX training run of
the tiny model costs more than a minute of XLA compiles on the CPU, and
what the port reads is the files.  Tolerance: f32 ``rtol=2e-3,
atol=2e-4``."""
import json
import os
import types
from collections import Counter

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.data import SingleVideoDataset as JDataset
from hpvaegan_tpu.serving import SamplerSession as JSession
from hpvaegan_tpu.serving import apply_snapshot as japply_snapshot
from hpvaegan_tpu_torch.cli import generate, train_video, \
    train_video_baselines
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.train import trainer_baselines
from hpvaegan_tpu_torch.utils.logger import kept_logging
from hpvaegan_tpu_torch.utils.tb_events import read_events
import torch_port_flax as flax_vars
from torch_port_runs import experiment, make_clip, one_torch_thread

RTOL, ATOL = 2e-3, 2e-4
BATCH = 2
TINY = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
        "--niter", "2", "--nfc", "8", "--num-layer", "2", "--batch-size",
        "2", "--manualSeed", "5", "--no-cuda"]
VAE_NB = ["--latent-dim", "8", "--enc-blocks", "1", "--vae-levels", "2",
          "--generator", "GeneratorVAE_nb"]
FILES = ["Z_init", "Noise_Amps", "Noise_Amps.json", "netG", "config.json",
         "logbook.txt", "eval"] + [f"netD_{s}" for s in range(5)]


class _Stop(Exception):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_clip(tmp_path_factory.mktemp("clip"))


def _run(clip, run_dir, *extra, callback=None, cli=train_video_baselines):
    with kept_logging():
        return cli.main(["--video-path", clip, *TINY, "--run-dir",
                         str(run_dir), *extra], callback=callback)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _steps(log):
    def callback(scale, event, it, info):
        if event == "step":
            log[scale] = log.get(scale, 0) + 1
    return callback


@pytest.fixture(scope="module")
def first_run(clip, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("brun")
    steps = {}
    cfg = _run(clip, run_dir, "--visualize", callback=_steps(steps))
    return run_dir, experiment(run_dir), cfg, steps


def test_cli_writes_the_baselines_file_set(first_run):
    run_dir, exp, cfg, steps = first_run
    assert cfg.generator == "GeneratorCSG"
    assert cfg.discriminator == "WDiscriminator3D"   # the reference's
    assert steps == {s: 2 for s in range(5)}   # a critic at every scale
    names = set(os.listdir(exp))
    assert set(FILES) <= names
    assert any(n.startswith("events.out.tfevents") for n in names)
    with open(os.path.join(exp, "Noise_Amps.json")) as f:
        amps = json.load(f)["noise_amps"]
    assert len(amps) == 5 and amps[0] == 1.0
    assert all(np.isfinite(a) and a > 0 for a in amps)
    z = _load(os.path.join(exp, "Z_init"))["data"]
    assert tuple(z.shape) == (BATCH, *cfg.pyramid().shape3d(0), 3)
    raw = _load(os.path.join(exp, "netG"))
    assert raw["scale"] == 4 and raw["noise_amps"] == amps
    assert len({k.split(".")[1] for k in raw["gvars"]
                if k.startswith("body.")}) == 5
    # --visualize: the baselines' five scalars every step (alpha > 0),
    # and the Real, Fake and Generated grids (frames and clip each) at
    # iteration 0 of every scale (trainer_baselines.py:209-236)
    (events,) = [read_events(os.path.join(exp, n)) for n in names
                 if n.startswith("events.out.tfevents")]
    scalars, images = Counter(), Counter()
    for e in events:
        for tag, kind, _ in e["values"]:
            name = tag.split("/")[-1]
            (scalars if kind == "scalar" else images)[
                (tag.split("/")[1], e["step"], name)] += 1
    assert set(scalars) == {(f"Scale_{s}", it, n) for s in range(5)
                            for it in range(2)
                            for n in ("errG", "errD_fake", "errD_real",
                                      "rec_loss", "noise_amp")}
    assert set(images) == {(f"Scale_{s}", 0, g + sfx) for s in range(5)
                           for g in ("Real", "Fake", "Generated")
                           for sfx in ("", "_unfold")}
    assert set(scalars.values()) == set(images.values()) == {1}


def test_netG_resume_reloads_z_init_and_warm_starts_from_the_resume_dir(
        clip, first_run, monkeypatch):
    """The resumed scale's critic comes from ``netD_3`` of the run resumed
    from (the new experiment has none: PARITY.md deviation 3), and the
    run keeps that run's ``Z_init`` instead of drawing one."""
    run_dir, exp, _, _ = first_run
    paths = []
    real = trainer_baselines._warm_start

    def record(D, path):
        paths.append(path)
        real(D, path)

    monkeypatch.setattr(trainer_baselines, "_warm_start", record)
    steps = {}
    _run(clip, run_dir, "--netG", os.path.join(exp, "netG"),
         callback=_steps(steps))
    assert steps == {4: 2} and paths == [os.path.join(exp, "netD_3")]
    exp1 = experiment(run_dir, 1)
    for name in ("Z_init",):
        assert torch.equal(_load(os.path.join(exp1, name))["data"],
                           _load(os.path.join(exp, name))["data"])
    with open(os.path.join(exp1, "Noise_Amps.json")) as f:
        assert len(json.load(f)["noise_amps"]) == 5


def test_netG_mid_resume_ends_with_the_uninterrupted_weights(clip,
                                                             tmp_path):
    """SinGAN with the BatchNorm critic: the interrupted run stops right
    after its netG_mid write at scale 1; the resume reloads Z_init, the
    critic and both optimizers and ends bit-equal."""
    flags = ("--generator", "GeneratorSG", "--discriminator",
             "WDiscriminatorBaselines", "--save-interval", "1")
    _run(clip, tmp_path / "a", *flags)

    def stop(scale, event, it, info):
        if scale == 1 and event == "step" and it == 0:
            raise _Stop

    with pytest.raises(_Stop):
        _run(clip, tmp_path / "b", *flags, callback=stop)
    mid = os.path.join(experiment(tmp_path / "b"), "netG_mid")
    raw_mid = _load(mid)
    assert (raw_mid["scale"], raw_mid["iteration"]) == (1, 1)
    steps = {}
    _run(clip, tmp_path / "b", *flags, "--netG", mid,
         callback=_steps(steps))
    assert steps == {1: 1, 2: 2, 3: 2, 4: 2}
    for name in ("netG", "netD_4"):
        a = _load(os.path.join(experiment(tmp_path / "a"), name))
        c = _load(os.path.join(experiment(tmp_path / "b", 1), name))
        key = "gvars" if name == "netG" else "dvars"
        assert set(a[key]) == set(c[key])
        for k, v in a[key].items():
            assert torch.equal(v, c[key][k]), (name, k)
        assert a.get("noise_amps") == c.get("noise_amps")


def test_baselines_train_over_a_data_mesh(clip, first_run, tmp_path,
                                          monkeypatch):
    """``--spmd --mesh-shape 2x1``: the CLI starts two gloo ranks, each
    with one sample of the batch (BatchNorm over the mesh, gradients
    summed), and rank 0 writes one run: its amps equal the single-process
    run's (which also ran ``--visualize``, whose forwards touch no
    weight), its weights differ only where a summation order flipped the
    sign of an Adam step (at most ``2 * lr`` a step, ten steps); a
    spatial axis raises before any step."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _run(clip, tmp_path / "m", "--spmd", "--mesh-shape", "2x1")
    exp = experiment(tmp_path / "m")
    assert not os.path.exists(experiment(tmp_path / "m", 1))
    one = first_run[1]
    for name in ("Noise_Amps.json",):
        with open(os.path.join(exp, name)) as f, \
                open(os.path.join(one, name)) as g:
            np.testing.assert_allclose(json.load(f)["noise_amps"],
                                       json.load(g)["noise_amps"],
                                       rtol=RTOL)
    a, b = (_load(os.path.join(d, "netG"))["gvars"] for d in (exp, one))
    worst = max(float((a[k] - b[k]).abs().max()) for k in a)
    assert worst <= 10 * 2 * 0.0005 * 1.01, worst
    cfg = types.SimpleNamespace(scale_idx=0, manualSeed=0,
                                generator="GeneratorCSG")
    G = types.SimpleNamespace(device="cpu",
                              mesh=types.SimpleNamespace(n_spatial=2))
    with pytest.raises(NotImplementedError, match="spatial mesh"):
        trainer_baselines.train_scale_baselines(cfg, G, None, None)


def test_vae_nb_trains_and_resumes_through_train_video(clip, tmp_path):
    steps = {}
    cfg = _run(clip, tmp_path, *VAE_NB, callback=_steps(steps),
               cli=train_video)
    assert cfg.generator == "GeneratorVAE_nb"
    assert steps == {s: 2 for s in range(5)}
    exp = experiment(tmp_path)
    raw = _load(os.path.join(exp, "netG"))
    assert any(k.startswith("encode.bern.") for k in raw["gvars"])
    steps = {}
    _run(clip, tmp_path, *VAE_NB, "--netG", os.path.join(exp, "netG"),
         callback=_steps(steps), cli=train_video)
    assert steps == {4: 2}
    out = generate.main(["--netG", os.path.join(exp, "netG"), "--no-cuda",
                         "--num-samples", "2", "--inject-scale", "2"])
    assert out["samples"].shape[0] == 2
    assert np.all(np.isfinite(out["samples"]))


def test_baseline_inject_scale_raises_as_the_jax_cli(first_run):
    _, exp, _, _ = first_run
    with pytest.raises(ValueError, match="requires GeneratorHPVAEGAN"):
        generate.main(["--netG", os.path.join(exp, "netG"), "--no-cuda",
                       "--inject-scale", "1"])
    # rand and rec (from Z_init) sample
    for mode in ("rand", "rec"):
        out = generate.main(["--netG", os.path.join(exp, "netG"),
                             "--no-cuda", "--mode", mode,
                             "--num-samples", "2"])
        assert np.all(np.abs(out["samples"]) <= 1.0)


# ---- the JAX package's checkpoints, sampled by both sessions ----

def _write_jax_checkpoint(clip, exp, name, extra):
    """A JAX-format experiment of a seeded tiny ``name`` model at scale 4:
    ``netG``, ``Noise_Amps`` (and ``Z_init`` for a baseline) through
    flax's serializer, and the JAX ``config.json`` snapshot."""
    os.makedirs(exp)
    jcfg = JConfig(video_path=clip, img_size=16, min_size=8, max_size=16,
                   nfc=8, num_layer=2, generator=name, **extra)
    jcfg.adjust_scales()
    JDataset(jcfg)   # sets ar and org_fps, as the JAX CLI's dataset does
    cfg = Config(**{k: v for k, v in jcfg.snapshot_dict().items()
                    if k in Config.__dataclass_fields__})
    cfg.sampling_rates = tuple(cfg.sampling_rates)
    G = make_generator(name, cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(21)
    G.init(gen)
    # scale 4: the baselines' body holds stage 0 too
    while len(G.body) < (4 if G.returns_triple else 5):
        G.init_next_stage(gen)
    amps = np.asarray([1.0, 0.3, 0.2, 0.15, 0.1], np.float32)

    def write(obj, fname):
        with open(os.path.join(exp, fname), "wb") as f:
            f.write(flax.serialization.to_bytes(obj))

    write({"scale": 4, "gvars": flax_vars.generator(G), "noise_amps": amps,
           "opt_g": {}}, "netG")
    write({"data": amps}, "Noise_Amps")
    if not G.returns_triple:
        write({"data": np.random.default_rng(22).standard_normal(
            (BATCH, *cfg.pyramid().shape3d(0), 3)).astype(np.float32)},
            "Z_init")
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(jcfg.snapshot_dict(), f)
    return os.path.join(exp, "netG")


def _sessions(netG):
    jcfg = JConfig(netG=netG)
    japply_snapshot(jcfg, netG, explicit=set(), user_chose_source=False)
    jcfg.adjust_scales()
    cfg = Config(netG=netG)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return (JSession(jcfg, batch_size=BATCH, manual_seed=3),
            SamplerSession(cfg, batch_size=BATCH, manual_seed=3,
                           device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_jax_baseline_checkpoint_samples_equal_the_jax_session(clip,
                                                               tmp_path):
    netG = _write_jax_checkpoint(clip, str(tmp_path / "exp"),
                                 "GeneratorCSG", {})
    jsess, psess = _sessions(netG)
    assert not psess.is_triple and psess.scale == 4 and len(
        psess.G.body) == 5
    assert tuple(jsess.noise_shape) == psess.noise_shape
    noise = np.random.default_rng(23).standard_normal(
        psess.noise_shape).astype(np.float32)
    key = jax.random.PRNGKey(24)
    ref = jsess.sample_fn(jsess.gvars, noise, key)
    noises = [None]
    for idx in range(1, len(psess.G.body)):   # generators.py:466-469
        key, k_n = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(
            k_n, psess.G._noise_shape(idx, BATCH))))
    _close(psess.sample_batch(noise=noise, noises=noises), ref)
    # rec from the checkpointed Z_init, no draw
    jzero, _ = jsess.rec_input()
    np.testing.assert_array_equal(psess.z_init(), np.asarray(jzero))
    ref = jsess.reconstruct_fn(jsess.gvars, jzero, jax.random.PRNGKey(25))
    _close(psess.reconstruct_batch(), ref)
    with pytest.raises(ValueError, match="requires GeneratorHPVAEGAN"):
        psess.inject_batch(np.zeros((BATCH, 4, 5, 10, 3), np.float32), 1)
    os.remove(os.path.join(os.path.dirname(netG), "Z_init"))
    psess._z_init = None
    with pytest.raises(RuntimeError, match="Z_init"):
        psess.reconstruct_batch()


def test_jax_vae_nb_checkpoint_samples_equal_the_jax_session(clip,
                                                             tmp_path):
    netG = _write_jax_checkpoint(clip, str(tmp_path / "exp"),
                                 "GeneratorVAE_nb",
                                 dict(latent_dim=4, enc_blocks=1,
                                      vae_levels=2))
    jsess, psess = _sessions(netG)
    pyr, latent = psess.pyramid, psess.cfg.latent_dim

    def draws(key, start=0):
        key, k_norm, k_bern = jax.random.split(key, 3)
        latents = (np.asarray(jax.random.normal(
            k_norm, (BATCH, 1, 1, 1, latent))), np.asarray(
            jax.random.bernoulli(k_bern, 0.5, (BATCH, *pyr.shape3d(0), 1)),
            np.float32))
        noises = [None] * len(psess.G.body)
        for idx in range(start, len(noises)):
            key, k_n = jax.random.split(key)
            noises[idx] = np.asarray(jax.random.normal(
                k_n, (BATCH, *pyr.shape3d(idx + 1), 3)))
        return latents, noises, (k_norm, k_bern)

    noise = np.zeros(psess.noise_shape, np.float32)
    key = jax.random.PRNGKey(26)
    latents, noises, _ = draws(key)
    _close(psess.sample_batch(noise=noise, noises=noises, latents=latents),
           jsess.sample_fn(jsess.gvars, noise, key))
    jzero, _ = jsess.rec_input()
    key = jax.random.PRNGKey(27)
    _, _, (k_norm, k_bern) = draws(key)
    eps = (np.asarray(jax.random.normal(k_norm, (BATCH, 1, 1, 1, latent))),
           np.asarray(jax.random.uniform(k_bern,
                                         (BATCH, *pyr.shape3d(0), 1))))
    _close(psess.reconstruct_batch(eps=eps),
           jsess.reconstruct_fn(jsess.gvars, jzero, key))
    start, key = 2, jax.random.PRNGKey(28)
    x_init = np.stack([psess.real_clip(start)] * BATCH)
    latents, noises, _ = draws(key, start)
    _close(psess.inject_batch(x_init, start, noises=noises, latents=latents),
           jsess.inject_fn(jsess.gvars, jnp.asarray(x_init), key, start))
