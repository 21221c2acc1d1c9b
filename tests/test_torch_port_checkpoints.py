"""The port's checkpoints (``hpvaegan_tpu_torch/utils/saver.py``,
``utils/msgpack_reader.py``): the JAX package's flax-msgpack files read
without flax or msgpack, a JAX run directory sampled by the port's
``SamplerSession``, and the port's own experiment tree and files, as
tests/test_saver.py holds the JAX saver's."""
import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.utils.saver import VideoSaver as JVideoSaver
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.utils import msgpack_reader
from hpvaegan_tpu_torch.utils.saver import (Saver, VideoSaver, apply_resume,
                                            load_critic, restore_generator,
                                            save_generator)

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True,
            video_path="/clips/wingsuit.avi")
SCALE, BATCH = 2, 2
AMPS = [1.0, 0.3, 0.2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is faster, and it
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls, **over):
    cfg = cls(**{**TINY, **over})
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX experiment directory as the JAX trainer leaves it after
    scale 2: netG, netD_2, Noise_Amps, config.json, written by the JAX
    package's own saver from a grown generator, a critic and their optax
    states."""
    jcfg = _cfg(JConfig, run_dir=str(tmp_path_factory.mktemp("jrun")))
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    for i in range(SCALE):
        gvars = jG.init_next_stage(gvars, jax.random.fold_in(key, 100 + i))
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3)
    dvars = jax.jit(jD.init)(jax.random.fold_in(key, 7),
                             jnp.zeros((BATCH, *jcfg.pyramid().shape3d(
                                 SCALE), 3)))
    ml, bl, lrs = joptim.hpvaegan_group_plan(jcfg, SCALE, SCALE)
    _, opt_g = joptim.build_g_optimizer(jcfg, joptim.gparams_view(gvars),
                                        ml, bl, lrs, jcfg.grad_clip)
    _, opt_d = joptim.build_d_optimizer(jcfg, joptim.dparams_view(dvars))
    saver = JVideoSaver(jcfg)
    amps = np.asarray(AMPS, np.float32)
    saver.save_checkpoint({"data": amps}, "Noise_Amps")
    saver.save_checkpoint({"scale": SCALE, "gvars": gvars,
                           "noise_amps": amps, "opt_g": opt_g}, "netG")
    saver.save_checkpoint({"scale": SCALE, "dvars": dvars, "opt_d": opt_d},
                          f"netD_{SCALE}", blocking=True)
    saver.save_json(jcfg.snapshot_dict(), "config.json")
    saver.wait()
    return saver.experiment_dir, jG, jax.tree_util.tree_map(np.asarray,
                                                            gvars), dvars


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", ["netG", f"netD_{SCALE}", "Noise_Amps"])
def test_reader_equals_flax_msgpack_restore(jax_run, name):
    path = os.path.join(jax_run[0], name)
    assert msgpack_reader.is_msgpack_file(path)
    with open(path, "rb") as f:
        want = fser.msgpack_restore(f.read())
    _assert_same_tree(msgpack_reader.read_file(path), want)


def test_reader_takes_every_flax_leaf_type():
    tree = {"int": 7, "neg": -40000, "big": 2 ** 40, "float": 0.25,
            "str": "x" * 40, "none": None, "flag": True, "cplx": 1 + 2j,
            "np_scalar": np.float32(3.5), "i8": np.arange(-3, 3, dtype=np.int8),
            "f64": np.linspace(0, 1, 5), "empty": np.zeros((0, 3), np.float32),
            "list": [np.ones(2, np.float32), {"a": 1}], "long": list(range(20))}
    data = fser.to_bytes(tree)
    _assert_same_tree(msgpack_reader.read(data), fser.msgpack_restore(data))
    with pytest.raises(ValueError, match="trailing"):
        msgpack_reader.read(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 9"):
        msgpack_reader.read(b"\xd4\x09\x00")


def test_session_samples_what_the_jax_generator_samples(jax_run):
    """``SamplerSession`` on the JAX run directory (its flax-msgpack netG
    and config.json), on the JAX forward's own draws."""
    exp, jG, gvars, _ = jax_run
    netG = os.path.join(exp, "netG")
    cfg = Config(netG=netG, pconv_all=True)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    session = SamplerSession(cfg, batch_size=BATCH, device="cpu")
    assert session.scale == SCALE and session.amps == pytest.approx(AMPS)
    pyr = session.pyramid
    noise_init = np.random.default_rng(0).standard_normal(
        (BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    (ref, _, _), _ = jax.jit(
        lambda gv, k, z: jG.apply(gv, jnp.asarray(AMPS), k, noise_init=z,
                                  mode="rand", train=True))(gvars, key,
                                                            noise_init)
    key, _ = jax.random.split(key)          # generators.py:174
    noises = [None]
    key, k_n = jax.random.split(key)        # the noisy stage, :255-256
    noises.append(np.asarray(jax.random.normal(
        k_n, (BATCH, *pyr.shape3d(SCALE), 3))))
    with torch.no_grad():
        out, _, _ = session.G.apply(session.amps, noise_init=noise_init,
                                    mode="rand", noises=noises)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    sample = session.sample_batch()
    assert sample.shape == (BATCH, *pyr.shape3d(SCALE), 3)
    assert np.all(np.isfinite(sample)) and np.abs(sample).max() <= 1.0


def test_apply_resume_and_critic_from_a_jax_run(jax_run):
    """A JAX end-of-scale netG resumes in the port: growth, weights, amps
    from the sibling Noise_Amps; its netD_<s> loads into the critic."""
    exp, _, gvars, dvars = jax_run
    cfg = _cfg(Config, netG=os.path.join(exp, "netG"))
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    apply_resume(cfg, G)
    assert (cfg.scale_idx, cfg.resumed_idx, len(G.body)) == (SCALE,) * 3
    assert cfg.Noise_Amps == pytest.approx(AMPS)
    assert not hasattr(cfg, "_mid_raw")
    np.testing.assert_array_equal(
        G.decoder.tail.bias.detach().numpy(),
        gvars["decoder"]["params"]["tail"]["conv"]["bias"])
    D = WDiscriminator(3, 64, 3, TINY["num_layer"], ndim=3)
    load_critic(os.path.join(exp, f"netD_{SCALE}"), D)
    np.testing.assert_array_equal(D.tail.bias.detach().numpy(),
                                  np.asarray(dvars["params"]["tail"]["conv"]
                                             ["bias"]))


@pytest.fixture
def saver(tmp_path):
    cfg = Config(video_path="/x/clip_name.avi", checkname="CHK",
                 run_dir=str(tmp_path))
    return VideoSaver(cfg)


def test_experiment_tree_layout(tmp_path, saver):
    assert saver.experiment_dir == os.path.join(
        str(tmp_path), "clip_name", "CHK", "experiment_0")
    assert os.path.isdir(saver.eval_dir)
    cfg2 = Config(video_path="/x/clip_name.avi", checkname="CHK",
                  run_dir=str(tmp_path))
    assert VideoSaver(cfg2).experiment_dir.endswith("experiment_1")
    # ids sort as numbers: after experiment_10 comes 11, not 10 again
    os.makedirs(os.path.join(saver.directory, "experiment_10"))
    assert Saver(cfg2, "clip_name").experiment_dir.endswith("experiment_11")


def test_checkpoint_round_trip_and_snapshot_at_save(saver):
    w = torch.arange(6.0).reshape(2, 3)
    state = {"scale": 3, "gvars": {"w": w, "body": [torch.ones(4)]},
             "amps": [1.0, 0.5]}
    saver.save_checkpoint(state, "ckpt")
    w.add_(100.0)          # an in-place update after the save: not saved
    saver.wait()
    raw = saver.load_checkpoint("ckpt")
    assert raw["scale"] == 3 and raw["amps"] == [1.0, 0.5]
    assert torch.equal(raw["gvars"]["w"], torch.arange(6.0).reshape(2, 3))
    assert not os.path.exists(os.path.join(saver.experiment_dir,
                                           "ckpt.tmp"))
    saver.save_json({"a": 1}, "x.json")
    with open(os.path.join(saver.experiment_dir, "x.json")) as f:
        assert json.load(f) == {"a": 1}


def test_async_write_then_wait(saver):
    for i in range(3):
        saver.save_checkpoint({"i": torch.tensor(i)}, f"async_{i}")
    saver.wait()
    for i in range(3):
        assert int(saver.load_checkpoint(f"async_{i}")["i"]) == i


def test_port_netG_restores_with_growth_replay(tmp_path):
    cfg = _cfg(Config)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    gen = torch.Generator().manual_seed(1)
    G.init(gen).init_next_stage(gen).init_next_stage(gen)
    path = str(tmp_path / "netG")
    save_generator(path, G, SCALE, AMPS)
    assert not msgpack_reader.is_msgpack_file(path)
    G2 = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G2.init(torch.Generator().manual_seed(2))
    raw = restore_generator(path, G2)
    assert raw["scale"] == SCALE and len(G2.body) == SCALE
    for k, v in G.state_dict().items():
        assert torch.equal(G2.state_dict()[k], v), k

    # a netG trained under --pconv-all (THWIO weights on the K1 route)
    # loads into a generator without the route, and samples the same
    cfg3 = _cfg(Config, pconv_all=False)
    G3 = make_generator(cfg3.generator, cfg3, cfg3.pyramid(), ndim=3)
    G3.init(torch.Generator().manual_seed(3))
    restore_generator(path, G3)
    assert G.body[0].blocks[0].conv.kernel_route
    assert not G3.body[0].blocks[0].conv.kernel_route
    z = torch.randn((BATCH, *cfg.pyramid().shape3d(0), cfg.latent_dim))
    noises = G.draw_stage_noises(BATCH, torch.Generator().manual_seed(4))
    with torch.no_grad():
        a, _, _ = G.apply(AMPS, noise_init=z, mode="rand", noises=noises)
        b, _, _ = G3.apply(AMPS, noise_init=z, mode="rand", noises=noises)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
