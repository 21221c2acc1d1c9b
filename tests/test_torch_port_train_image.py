"""The port's 2D path against the JAX package's, on the CPU:

* ``calibrate``, ``vae_step`` and ``gan_step`` of a tiny 2D model against
  the JAX jitted steps, from the same weights and with JAX's draws
  replayed (as tests/test_torch_port_train_step.py at 3D);
* ``python -m hpvaegan_tpu_torch.cli.train_image`` on the verify
  recipe's tiny drive: the JAX CLI's file set, ``config.json`` with the
  JAX snapshot's keys, the 2D ``Z_init_size``, a ``--netG`` resume, the
  unported flags raising, a sharded run over two gloo ranks;
* the JAX CLI's tiny 2D run sampled by the port's ``SamplerSession``
  (rand and rec batches equal JAX's on JAX's draws, the PNGs it writes)
  and by ``cli.generate --sifid`` / ``cli.serve``.

Tolerances: the f32 bar rtol 2e-3 / atol 2e-4; parameters after one Adam
step within ``2 * lr`` with at most 0.5% of elements beyond the bar (see
tests/test_torch_port_train_step.py); SIFID rtol 1e-4."""
import json
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpvaegan_tpu.eval as je
from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.serving import SamplerSession as JSession
from hpvaegan_tpu.serving import apply_snapshot as japply_snapshot
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_hpvaegan_steps
from hpvaegan_tpu_torch.cli import generate, serve, train_image
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
from hpvaegan_tpu_torch.utils.logger import kept_logging
from hpvaegan_tpu_torch.utils.png import read_png
from torch_port_runs import (TINY_IMAGE, image_experiment, make_image,
                             one_torch_thread, port_image_run,
                             shared_jax_run)

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=16, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2)
BATCH = 2
VAE_SCALE, GAN_SCALE = 1, 3
AMPS = [1.0, 0.3, 0.2, 0.15]
TOP = (16, 16)          # (H, W) of the tiny image runs' top scale, scale 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar = 0.75
    cfg.adjust_scales()
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


@pytest.fixture(scope="module")
def jax_models():
    jcfg = _cfg(JConfig)
    jG = JGenerator(jcfg, jcfg.pyramid2d(), ndim=2)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    grown = []
    for i in range(GAN_SCALE):
        gvars = jG.init_next_stage(gvars, jax.random.fold_in(key, 100 + i))
        grown.append(_np(gvars))
    jD = JCritic(nfc=TINY["nfc"], ker_size=3, num_layer=jcfg.num_layer,
                 ndim=2)
    shape = (BATCH, *jcfg.pyramid2d().shape2d(GAN_SCALE), 3)
    dvars = _np(jax.jit(jD.init)(jax.random.fold_in(key, 7),
                                 jnp.zeros(shape)))
    return jcfg, jG, {VAE_SCALE: grown[0], GAN_SCALE: grown[-1]}, jD, dvars


def _port_generator(gvars, scale):
    cfg = _cfg(Config)
    cfg.scale_idx = scale
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid2d(), ndim=2)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    G.requires_grad_(True)
    return cfg, G


def _port_critic(dvars):
    D = WDiscriminator(3, TINY["nfc"], 3, TINY["num_layer"], ndim=2)
    convert.load_discriminator(D, dvars)
    return D


def _data(pyr, scale, seed):
    rng = np.random.default_rng(seed)
    real = np.tanh(rng.standard_normal((BATCH, *pyr.shape2d(scale), 3)))
    real_zero = np.tanh(rng.standard_normal((BATCH, *pyr.shape2d(0), 3)))
    return real.astype(np.float32), real_zero.astype(np.float32)


def _eps_of(key, pyr, latent):
    _, k_rep = jax.random.split(key)
    return np.asarray(jax.random.normal(k_rep, (BATCH, *pyr.shape2d(0),
                                                latent)))


def _noises_of(key, pyr, n_stages):
    """A 2D rand forward's stage noises: every stage draws one
    (networks_2d.py:261; generators.py:255-256)."""
    key, _ = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        key, k_n = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(
            k_n, (BATCH, *pyr.shape2d(idx + 1), 3))))
    return noises


def _jax_steps(jcfg, jG, jD, gvars, scale, dvars=None):
    pview = joptim.gparams_view(gvars)
    ml, bl, lrs = joptim.hpvaegan_group_plan(jcfg, scale, len(gvars["body"]))
    tx_g, opt_g = joptim.build_g_optimizer(jcfg, pview, ml, bl, lrs,
                                           jcfg.grad_clip)
    tx_d = opt_d = None
    if dvars is not None:
        tx_d, opt_d = joptim.build_d_optimizer(jcfg, dvars["params"])
    fns = make_hpvaegan_steps(jG, jD, jcfg, tx_g, tx_d, group_plan=(ml, bl))
    return fns, opt_g, opt_d, lrs


def _assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_params_after_adam(module, ref, lr_max):
    want = dict(ref.named_parameters())
    off = total = 0
    for name, p in module.named_parameters():
        got, exp = p.detach().numpy(), want[name].detach().numpy()
        diff = np.abs(got - exp)
        assert diff.max() <= 2 * lr_max * 1.01 + ATOL, (name, diff.max())
        off += int(np.sum(diff > ATOL + RTOL * np.abs(exp)))
        total += diff.size
    assert off <= 0.005 * total, (off, total)


def _assert_metrics_close(got, ref):
    for name, value in ref.items():
        np.testing.assert_allclose(float(got[name]), float(value),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_calibrate_2d_matches_jax(jax_models):
    jcfg, jG, gv, _, _ = jax_models
    gvars = gv[GAN_SCALE]
    fns, _, _, _ = _jax_steps(jcfg, jG, None, gvars, GAN_SCALE)
    cfg, G = _port_generator(gvars, GAN_SCALE)
    pyr = cfg.pyramid2d()
    real, real_zero = _data(pyr, GAN_SCALE, seed=1)
    key = jax.random.PRNGKey(21)
    amps = AMPS[:GAN_SCALE] + [0.0]
    rmse_ref, gv_new = fns["calibrate"](_copy(gvars), real, real_zero,
                                        jnp.asarray(amps), key)
    rmse = steps.calibrate(G, real, real_zero, amps,
                           eps=_eps_of(key, pyr, cfg.latent_dim))
    np.testing.assert_allclose(float(rmse), float(rmse_ref), rtol=RTOL)
    _, ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, ref)


def test_vae_step_2d_matches_jax(jax_models):
    jcfg, jG, gv, _, _ = jax_models
    gvars = gv[VAE_SCALE]
    fns, opt_g_j, _, lrs = _jax_steps(jcfg, jG, None, gvars, VAE_SCALE)
    cfg, G = _port_generator(gvars, VAE_SCALE)
    pyr = cfg.pyramid2d()
    real, real_zero = _data(pyr, VAE_SCALE, seed=2)
    key = jax.random.PRNGKey(22)
    amps = AMPS[:VAE_SCALE + 1]
    gv_new, _, metrics_ref = fns["vae_step"](_copy(gvars), opt_g_j, real,
                                             real_zero, jnp.asarray(amps),
                                             key)
    opt_g = optim.build_g_optimizer(cfg, G, VAE_SCALE)
    metrics = steps.vae_step(G, opt_g, cfg, real, real_zero, amps,
                             eps=_eps_of(key, pyr, cfg.latent_dim))
    _assert_metrics_close(metrics, metrics_ref)
    _, ref = _port_generator(_np(gv_new), VAE_SCALE)
    _assert_buffers_close(G, ref)
    _assert_params_after_adam(G, ref, max(lrs.values()))


def test_gan_step_2d_matches_jax(jax_models):
    """Scale 3 with vae_levels 2: every stage's rand forward draws noise
    (the 2D rule), stage 2 is frozen, stage 3 trains."""
    jcfg, jG, gv, jD, dvars = jax_models
    gvars = gv[GAN_SCALE]
    fns, opt_g_j, opt_d_j, lrs = _jax_steps(jcfg, jG, jD, gvars, GAN_SCALE,
                                            dvars)
    cfg, G = _port_generator(gvars, GAN_SCALE)
    D = _port_critic(dvars)
    pyr = cfg.pyramid2d()
    real, real_zero = _data(pyr, GAN_SCALE, seed=3)
    noise_init = np.random.default_rng(4).standard_normal(
        (BATCH, *pyr.shape2d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    amps = AMPS[:GAN_SCALE + 1]
    gv_new, dv_new, _, _, metrics_ref = fns["gan_step"](
        _copy(gvars), _copy(dvars), opt_g_j, opt_d_j, real, real_zero,
        noise_init, jnp.asarray(amps), key)

    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    opt_g = optim.build_g_optimizer(cfg, G, GAN_SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    metrics = steps.gan_step(
        G, D, opt_g, opt_d, cfg, real, real_zero, noise_init, amps,
        noises=_noises_of(k_fake, pyr, GAN_SCALE),
        eps=_eps_of(k_rec, pyr, cfg.latent_dim),
        alpha=float(jax.random.uniform(k_gp, ())))
    # errG reads the updated critic, whose tail bias has a gradient of
    # exactly zero (the real and fake means cancel): rounding decides
    # whether, and which way, its first Adam step moves it by lr_d.  The
    # critic's output, so errG and the loss, shift by that bias's
    # difference; held net of it
    D_ref = _port_critic(_np(dv_new))
    shift = float(D.tail.bias.detach() - D_ref.tail.bias.detach()) \
        * cfg.disc_loss_weight
    assert abs(shift) <= 2 * cfg.lr_d * cfg.disc_loss_weight * 1.01
    metrics = {**metrics, "errG": float(metrics["errG"]) + shift,
               "loss": float(metrics["loss"]) + shift}
    _assert_metrics_close(metrics, metrics_ref)
    _, G_ref = _port_generator(_np(gv_new), GAN_SCALE)
    _assert_buffers_close(G, G_ref)
    _assert_params_after_adam(G, G_ref, max(lrs.values()))
    _assert_buffers_close(D, D_ref)
    _assert_params_after_adam(D, D_ref, cfg.lr_d)


# ---- the CLI ----

@pytest.fixture(scope="module")
def image(tmp_path_factory):
    return make_image(tmp_path_factory.mktemp("image"))


@pytest.fixture(scope="module")
def runs(image, tmp_path_factory):
    return {"jax": shared_jax_run(tmp_path_factory, "image"),
            "port": port_image_run(image, tmp_path_factory.mktemp("prun"))}


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_cli_writes_the_jax_file_set(runs):
    def names(exp):
        return {n for n in os.listdir(exp)
                if not n.startswith("events.out.tfevents.") and n != "done"}

    exp = runs["port"]
    assert names(exp) == names(runs["jax"]) == {
        "netG", "netD_2", "netD_3", "netD_4", "Noise_Amps",
        "Noise_Amps.json", "config.json", "logbook.txt", "eval"}
    assert any(n.startswith("events.out.tfevents.") for n in os.listdir(exp))
    with open(os.path.join(exp, "Noise_Amps.json")) as f:
        amps = json.load(f)
    assert amps["scale"] == 4 and len(amps["noise_amps"]) == 5
    assert amps["noise_amps"][0] == 1.0
    assert all(np.isfinite(a) and a > 0 for a in amps["noise_amps"])
    raw = _load(os.path.join(exp, "netG"))
    assert set(raw) == {"scale", "gvars", "noise_amps", "opt_g"}
    assert raw["scale"] == 4 and raw["noise_amps"] == amps["noise_amps"]


def test_config_json_has_the_jax_snapshot_keys(runs):
    with open(os.path.join(runs["port"], "config.json")) as f:
        snap = json.load(f)
    with open(os.path.join(runs["jax"], "config.json")) as f:
        jsnap = json.load(f)
    assert set(snap) == set(jsnap) == set(JConfig().snapshot_dict())
    for key in ("ar", "stop_scale", "manualSeed", "data_rep", "image_path",
                "video_path"):
        assert os.path.basename(str(snap[key])) == \
            os.path.basename(str(jsnap[key])), key
    assert snap["data_rep"] == 1000 and snap["video_path"] == ""


def test_z_init_geometry_and_data_rep_clamp(image, tmp_path):
    """The 2D decoder latent is the scale-0 shape at every scale
    (train_image.py:137-139), and data_rep is clamped to the batch."""
    with kept_logging():
        cfg = train_image.main(["--image-path", image, *TINY_IMAGE,
                                "--run-dir", str(tmp_path),
                                "--data-rep", "1", "--stop-scale-time",
                                "-1", "--niter", "1", "--vae-levels", "5"])
    h0, w0 = cfg.pyramid2d().shape2d(0)
    assert cfg.Z_init_size == [2, h0, w0, 8]
    assert cfg.data_rep == 2


def test_netG_resume_replays_growth_and_keeps_the_amps(image, runs,
                                                      tmp_path):
    netG = os.path.join(runs["port"], "netG")
    seen = set()
    with kept_logging():
        train_image.main(["--image-path", image, *TINY_IMAGE, "--run-dir",
                          str(tmp_path), "--netG", netG],
                         callback=lambda s, e, i, m: seen.add(s))
    assert seen == {4}
    raw = _load(os.path.join(image_experiment(tmp_path), "netG"))
    assert raw["scale"] == 4 and len(raw["noise_amps"]) == 5
    # read back from the Noise_Amps file, which holds them in f32
    assert raw["noise_amps"] == _load(os.path.join(
        runs["port"], "Noise_Amps"))["data"].tolist()


@pytest.mark.parametrize("flag", [["--scan-steps", "2"], ["--remat"],
                                  ["--compile-ahead"], ["--fast-grads"]])
def test_unported_flags_raise_naming_their_roadmap_item(image, tmp_path,
                                                       flag):
    with pytest.raises(NotImplementedError, match=f"{flag[0]}.*ROADMAP"):
        train_image.main(["--image-path", image, *TINY_IMAGE, "--run-dir",
                          str(tmp_path), *flag])
    assert not os.listdir(str(tmp_path))


def test_the_neptune_branch_needs_tag_project_and_client(monkeypatch,
                                                         caplog):
    cfg = Config(tag="")
    monkeypatch.setenv("NEPTUNE_PROJECT", "team/proj")
    assert train_image._neptune_experiment(cfg) is None
    cfg.tag = "t"
    monkeypatch.delenv("NEPTUNE_PROJECT")
    assert train_image._neptune_experiment(cfg) is None
    monkeypatch.setenv("NEPTUNE_PROJECT", "team/proj")
    monkeypatch.setitem(__import__("sys").modules, "neptune", None)
    caplog.set_level(logging.WARNING)
    assert train_image._neptune_experiment(cfg) is None
    assert any("neptune disabled" in r.getMessage() for r in caplog.records)


def test_without_no_cuda_the_cli_needs_a_card(image, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    argv = ["--image-path", image,
            *[a for a in TINY_IMAGE if a != "--no-cuda"],
            "--run-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_image.main(argv)


def test_sharded_run_over_two_ranks(image, runs, tmp_path, monkeypatch):
    """``--spmd --mesh-shape 1x2`` starts two gloo ranks, as
    ``cli.train_video`` does: rank 0 alone writes the file set, and the
    weights stay within the step bar of the one-process run's (10
    generator steps, 6 critic steps of lr 5e-4)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    train_image.main(["--image-path", image, *TINY_IMAGE, "--run-dir",
                      str(tmp_path), "--spmd", "--mesh-shape", "1x2"])
    exp = image_experiment(tmp_path)
    assert not os.path.exists(image_experiment(tmp_path, 1))
    with open(os.path.join(exp, "logbook.txt")) as f:
        assert "rank 0 of 2" in f.read()
    ref = _load(os.path.join(runs["port"], "netG"))["gvars"]
    got = _load(os.path.join(exp, "netG"))["gvars"]
    for k, v in ref.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=10 * 2 * 5e-4 + ATOL,
                                       err_msg=k)


# ---- sampling a JAX-trained 2D run ----

def _port_session(exp):
    netG = os.path.join(exp, "netG")
    cfg = Config(netG=netG)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return SamplerSession(cfg, batch_size=BATCH, manual_seed=3,
                          device="cpu")


def _jax_session(exp):
    netG = os.path.join(exp, "netG")
    cfg = JConfig(netG=netG)
    japply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    return JSession(cfg, batch_size=BATCH, manual_seed=3)


@pytest.fixture(scope="module")
def sessions(runs):
    return _jax_session(runs["jax"]), _port_session(runs["jax"])


def test_session_geometry_equals_jax(sessions):
    jsess, psess = sessions
    assert psess.ndim == jsess.ndim == 2
    assert psess.scale == jsess.scale == 4
    assert psess.noise_shape == tuple(jsess.noise_shape)
    np.testing.assert_allclose(psess.amps, np.asarray(jsess.amps),
                               rtol=1e-6)
    (jzero, jcur), (pzero, pcur) = jsess.rec_input(), psess.rec_input()
    np.testing.assert_array_equal(pzero, np.asarray(jzero))
    np.testing.assert_array_equal(pcur, np.asarray(jcur))


@pytest.mark.parametrize("seed", [11, 12])
def test_rand_batch_equals_jax(sessions, seed):
    jsess, psess = sessions
    noise = np.random.default_rng(seed).standard_normal(
        psess.noise_shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsess.sample_fn(jsess.gvars, noise, key))
    out = psess.sample_batch(noise=noise, noises=_noises_of(
        key, psess.pyramid, len(psess.G.body)))
    assert out.shape == (BATCH, *TOP, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_rec_batch_equals_jax(sessions):
    jsess, psess = sessions
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jsess.reconstruct_fn(jsess.gvars,
                                          jsess.rec_input()[0], key))
    out = psess.reconstruct_batch(eps=_eps_of(key, psess.pyramid,
                                              psess.cfg.latent_dim))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_write_sample_is_the_jax_png(sessions, tmp_path):
    jsess, psess = sessions
    x = np.tanh(np.random.default_rng(5).standard_normal(
        (*TOP, 3))).astype(np.float32) * 1.2
    jpath = jsess.write_sample(x, str(tmp_path / "j"))
    ppath = psess.write_sample(x, str(tmp_path / "p"))
    assert ppath.endswith(".png")
    import imageio.v2 as imageio
    np.testing.assert_array_equal(read_png(ppath),
                                  np.asarray(imageio.imread(jpath)))


def _logged(caplog, pattern):
    found = [m for r in caplog.records
             for m in [re.search(pattern, r.getMessage())] if m]
    assert len(found) == 1, [r.getMessage() for r in caplog.records]
    return found[0]


@pytest.mark.parametrize("which", ["jax", "port"])
@pytest.mark.parametrize("mode", ["rand", "rec", "inject"])
def test_generate_sifid_on_both_runs(runs, image, which, mode, tmp_path,
                                     caplog):
    """``--image-path ... --sifid --metrics``: PNGs read back as the
    samples' de-normalisation, and the SIFID line of the JAX CLI, whose
    score equals the JAX package's on the same samples."""
    caplog.set_level(logging.INFO)
    extra = (["--inject-scale", "2"] if mode == "inject"
             else ["--mode", mode])
    res = generate.main(["--netG", os.path.join(runs[which], "netG"),
                         "--no-cuda", "--output-dir", str(tmp_path),
                         "--image-path", image, "--num-samples", "3",
                         "--sifid", "--metrics", *extra])
    stem = "inject" if mode == "inject" else "sample"
    assert res["paths"] == [str(tmp_path / f"{stem}_{i}.png")
                            for i in range(3)]
    for path, s in zip(res["paths"], res["samples"]):
        assert s.shape == (*TOP, 3)
        np.testing.assert_array_equal(
            read_png(path), np.uint8((np.clip(s, -1, 1) + 1.0) * 127.5))
    m = _logged(caplog, r"SIFID\[pool1\] \(RANDOM stem — relative only\): "
                        r"mean ([0-9.]+)  per-sample \[")
    want = je.sifid(_port_session(runs[which]).real_clip(4),
                    list(res["samples"]))
    np.testing.assert_allclose(res["metrics"]["sifid"]["mean"],
                               want["mean"], rtol=1e-4)
    assert float(m.group(1)) == pytest.approx(want["mean"], abs=1e-4)
    assert res["eval_ms"]["sifid"] > 0
    key = "psnr" if mode == "rec" else "diversity"
    assert np.isfinite(res["metrics"][key])


def test_generate_svfid_needs_a_video(runs, tmp_path):
    with pytest.raises(ValueError, match="--svfid is a video metric"):
        generate.main(["--netG", os.path.join(runs["port"], "netG"),
                       "--no-cuda", "--output-dir", str(tmp_path),
                       "--svfid"])


def test_serve_answers_2d_requests(runs, tmp_path):
    server, _ = serve.make_server(["--netG",
                                   os.path.join(runs["port"], "netG"),
                                   "--no-cuda", "--output-dir",
                                   str(tmp_path), "--warm", "rand,rec"])
    try:
        assert server.info()["ndim"] == 2
        for req in ({"num_samples": 3, "seed": 4}, {"mode": "rec"}):
            resp = server.handle(req)
            assert resp["ok"], resp
            for path in resp["paths"]:
                assert path.endswith(".png")
                assert read_png(path).shape == (*TOP, 3)
    finally:
        server.close()
