"""The slice as a whole: a tiny 3D ``GeneratorHPVAEGAN`` with nfc 64 under
``pconv_all`` (so the K1 route is taken) in the JAX package and in the
port, on the same weights and the same random draws; then the port's
``SamplerSession`` round trip through its own checkpoint."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.models.generators import GeneratorHPVAEGAN as JGenerator
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.utils import convert
from hpvaegan_tpu_torch.utils.saver import save_generator

RTOL, ATOL = 2e-3, 2e-4
TINY = dict(img_size=16, min_size=8, max_size=16, nfc=64, latent_dim=8,
            num_layer=2, enc_blocks=1, vae_levels=2, pconv_all=True)
SCALE, BATCH = 2, 2
AMPS = [1.0, 0.3, 0.2]


def _cfg(cls):
    cfg = cls(**TINY)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    return cfg


@pytest.fixture(scope="module")
def models():
    """JAX generator grown to SCALE, and the port generator converted
    from it."""
    jcfg = _cfg(JConfig)
    jG = JGenerator(jcfg, jcfg.pyramid(), ndim=3)
    key = jax.random.PRNGKey(0)
    gvars = jax.jit(lambda k: jG.init(k, batch_size=BATCH))(key)
    for i in range(SCALE):
        gvars = jax.jit(jG.init_next_stage)(gvars,
                                            jax.random.fold_in(key, 100 + i))
    gvars = jax.tree_util.tree_map(np.asarray, gvars)

    cfg = _cfg(Config)
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    convert.load_generator(G, gvars)
    return jG, gvars, G, cfg


def _replay_stage_noises(key, pyramid, vae_levels, n_stages):
    """The JAX rand-mode draws: generators.py:174 splits off the
    reparameterization key, then :255-256 splits once per noisy stage."""
    key, k_rep = jax.random.split(key)
    noises = []
    for idx in range(n_stages):
        if vae_levels <= idx + 1:
            key, k_n = jax.random.split(key)
            shape = (BATCH, *pyramid.shape3d(idx + 1), 3)
            noises.append(np.asarray(jax.random.normal(k_n, shape)))
        else:
            noises.append(None)
    return k_rep, noises


def test_rand_mode_matches_jax(models):
    jG, gvars, G, cfg = models
    pyr = cfg.pyramid()
    noise_init = np.random.default_rng(0).standard_normal(
        (BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    (ref, ref_vae, _), _ = jax.jit(
        lambda gv, k, z: jG.apply(gv, jnp.asarray(AMPS), k, noise_init=z,
                                  mode="rand", train=True))(gvars, key,
                                                            noise_init)
    _, noises = _replay_stage_noises(key, pyr, cfg.vae_levels, SCALE)
    assert noises[0] is None and noises[1] is not None  # 3D: post-VAE only

    cp.counts.reset()
    with torch.no_grad():
        out, vae, stats = G.apply(AMPS, noise_init=noise_init, mode="rand",
                                  train=True, noises=noises)
    assert stats is None
    assert cp.counts.plain_calls == cfg.num_layer * SCALE
    assert cp.counts.fwd_launches == 0
    assert out.shape == (BATCH, *pyr.shape3d(SCALE), 3)
    np.testing.assert_allclose(vae.numpy(), np.asarray(ref_vae), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_rec_mode_matches_jax(models):
    jG, gvars, G, cfg = models
    pyr = cfg.pyramid()
    real_zero = np.tanh(np.random.default_rng(1).standard_normal(
        (BATCH, *pyr.shape3d(0), 3))).astype(np.float32)
    key = jax.random.PRNGKey(12)
    (ref, _, (mu_ref, logvar_ref)), _ = jax.jit(
        lambda gv, k, x: jG.apply(gv, jnp.asarray(AMPS), k, real_zero=x,
                                  mode="rec", train=True))(gvars, key,
                                                           real_zero)
    k_rep, _ = _replay_stage_noises(key, pyr, cfg.vae_levels, SCALE)
    eps = np.asarray(jax.random.normal(k_rep, mu_ref.shape))

    with torch.no_grad():
        out, _, (mu, logvar) = G.apply(AMPS, real_zero=real_zero,
                                       mode="rec", train=True, eps=eps)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_sampler_session_round_trip(models, tmp_path):
    _, _, G, cfg = models
    cfg = _cfg(Config)
    cfg.video_path = "data/vids/wingsuit.avi"
    netG = tmp_path / "netG"
    save_generator(str(netG), G, SCALE, AMPS)
    (tmp_path / "config.json").write_text(json.dumps(cfg.snapshot_dict()))

    scfg = Config(pconv_all=True, netG=str(netG))
    applied = apply_snapshot(scfg, str(netG), explicit=set(),
                             user_chose_source=False)
    assert "nfc" in applied and "video_path" in applied
    scfg.adjust_scales()
    session = SamplerSession(scfg, batch_size=BATCH, manual_seed=0,
                             device="cpu")
    assert session.scale == SCALE and session.amps == AMPS
    for k, v in G.state_dict().items():
        assert torch.equal(session.G.state_dict()[k], v), k

    shape = (BATCH, *cfg.pyramid().shape3d(SCALE), 3)
    cp.counts.reset()
    sample = session.sample_batch()
    assert cp.counts.plain_calls == cfg.num_layer * SCALE
    rec = session.reconstruct_batch(
        np.zeros((*cfg.pyramid().shape3d(0), 3), np.float32))
    for out in (sample, rec):
        assert out.shape == shape and out.dtype == np.float32
        assert np.all(np.isfinite(out))
        assert np.all(np.abs(out) <= 1.0)
    session.warmup(("rand", "rec"))
    with pytest.raises(ValueError):
        session.warmup(("nope",))

    if not torch.cuda.is_available():
        # the default device is the card, and there is none: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SamplerSession(scfg, batch_size=BATCH)


def test_session_needs_geometry_snapshot(models, tmp_path):
    _, _, G, _ = models
    netG = tmp_path / "netG"
    save_generator(str(netG), G, SCALE, AMPS)
    cfg = _cfg(Config)
    cfg.video_path, cfg.netG = "clip.avi", str(netG)
    with pytest.raises(RuntimeError, match="config.json"):
        SamplerSession(cfg, device="cpu")
    cfg.video_path = ""
    with pytest.raises(RuntimeError, match="no source clip"):
        SamplerSession(cfg, device="cpu")


def _param_count(tree) -> int:
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(tree["params"]))


def test_every_generator_builds_with_the_jax_parameter_counts():
    """The generators the port once refused build now, with the JAX
    package's parameter count per stage and per shared module (shapes
    only: ``jax.eval_shape`` traces the JAX init without running it);
    an unknown name still raises."""
    from hpvaegan_tpu.models import generators as jgen
    for name in ("GeneratorVAE_nb", "GeneratorCSG", "GeneratorSG"):
        cfg, jcfg = _cfg(Config), _cfg(JConfig)
        cfg.generator = jcfg.generator = name
        G = make_generator(name, cfg, cfg.pyramid(), ndim=3)
        G.init(torch.Generator().manual_seed(0))
        jG = getattr(jgen, name)(jcfg, jcfg.pyramid(), 3)

        def grown(key, jG=jG):
            gv = jG.init(key)
            return jG.init_next_stage(gv, key)

        shapes = jax.eval_shape(grown, jax.random.PRNGKey(0))
        G.init_next_stage(torch.Generator().manual_seed(1))
        assert len(G.body) == len(shapes["body"]), name
        for stage, tree in zip(G.body, shapes["body"]):
            assert sum(p.numel() for p in stage.parameters()) == \
                _param_count(tree), name
        for module in ("encode", "decoder", "head", "tail"):
            if module in shapes:
                assert sum(p.numel() for p in getattr(G, module).parameters()
                           ) == _param_count(shapes[module]), (name, module)
    with pytest.raises(ValueError):
        make_generator("Nope", cfg, cfg.pyramid(), ndim=3)
