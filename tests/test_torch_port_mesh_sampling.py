"""Sampling over a mesh: the port's ``SamplerSession(mesh_shape=...)`` on
(data, spatial) meshes (1, 2), (2, 1) and (2, 2) of gloo CPU ranks
(``tests/torch_port_ranks.py``, each group started once for the module),
against the one-process port session and (the f32 model) the JAX
session with the same ``mesh_shape`` on the 8 virtual CPU devices of
tests/conftest.py, on JAX's draws.

The experiments are JAX-format checkpoints of seeded port models (as
tests/test_torch_port_baselines_cli.py writes them): the tiny nfc-64
pyramid under ``pconv_all`` on the test clip (stage heights 6, 7, 9,
10, 12: the 2-way spatial axis leaves 7 and 9 uneven), so every stage
conv of a rank
runs K4's plain composition, sampled in rand, rec and inject mode (from
level 2, the path training never takes under a mesh); the same model
under ``bf16``; the same at ``h_factor=2``; a 2D model; and, in rand and
rec mode on numpy draws, ``GeneratorVAE_nb`` and ``GeneratorCSG`` (rec
from its checkpointed ``Z_init``).  Each rank returns the whole batch
(``Mesh.gather_whole``), so every rank's output is held against the
references.

Bars: f32 ``rtol=2e-3, atol=2e-4``; bf16 the JAX package's,
``5e-2 * max(1, |ref|)`` (tests/test_torch_port_bf16_models.py).  The
mesh's batch statistics are summed in another order than one process's,
so the samples agree within the bar, not bit for bit."""
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core.config import Config as JConfig
from hpvaegan_tpu.data import SingleVideoDataset as JDataset
from hpvaegan_tpu.data.image import SingleImageDataset as JImageDataset
from hpvaegan_tpu.parallel import shard_batch
from hpvaegan_tpu.serving import SamplerSession as JSession
from hpvaegan_tpu.serving import apply_snapshot as japply_snapshot
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
import torch_port_flax as flax_vars
from torch_port_ranks import (MESHES, port_session, results, session_calls,
                              start_ranks, wait_ranks)
from torch_port_runs import make_clip, make_image, one_torch_thread

RTOL, ATOL = 2e-3, 2e-4
BF16_BAR = 5e-2
BATCH, SCALE, START = 2, 4, 2
MESH_SHAPES = [shape for world in (2, 4) for shape in MESHES[world]]
WIDE = dict(img_size=16, min_size=8, max_size=16, nfc=64, num_layer=2,
            latent_dim=8, enc_blocks=1, vae_levels=2, pconv_all=True)
SMALL = dict(img_size=16, min_size=8, max_size=16, nfc=8, num_layer=2,
             latent_dim=8, enc_blocks=1, vae_levels=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _write_experiment(exp, source: dict, ndim: int, **over) -> str:
    """A JAX-format experiment of a seeded port generator (``over``'s, by
    default ``GeneratorHPVAEGAN``) at ``SCALE``: ``netG`` (and a
    baseline's ``Z_init``) through flax's serializer and the JAX
    ``config.json`` snapshot."""
    os.makedirs(exp)
    jcfg = JConfig(**source, **over)
    jcfg.adjust_scales()
    # the datasets set ar (and org_fps), as the JAX CLIs' do
    (JDataset if ndim == 3 else JImageDataset)(jcfg)
    cfg = Config(**{k: v for k, v in jcfg.snapshot_dict().items()
                    if k in Config.__dataclass_fields__})
    cfg.sampling_rates = tuple(cfg.sampling_rates)
    pyr = cfg.pyramid() if ndim == 3 else cfg.pyramid2d()
    G = make_generator(cfg.generator, cfg, pyr, ndim=ndim)
    gen = torch.Generator().manual_seed(31)
    G.init(gen)
    # a baseline's body holds stage 0 too
    while len(G.body) < SCALE + (not G.returns_triple):
        G.init_next_stage(gen)
    amps = np.asarray([1.0, 0.3, 0.2, 0.15, 0.1], np.float32)

    def write(obj, name):
        with open(os.path.join(exp, name), "wb") as f:
            f.write(flax.serialization.to_bytes(obj))
    write({"scale": SCALE, "gvars": flax_vars.generator(G),
           "noise_amps": amps, "opt_g": {}}, "netG")
    if not G.returns_triple:
        write({"data": np.random.default_rng(32).standard_normal(
            (BATCH, *pyr.shape3d(0), 3)).astype(np.float32)}, "Z_init")
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(jcfg.snapshot_dict(), f)
    return os.path.join(exp, "netG")


def _jax_session(netG, mesh_shape="", **kw):
    jcfg = JConfig(netG=netG)
    japply_snapshot(jcfg, netG, explicit=set(), user_chose_source=False)
    jcfg.adjust_scales()
    return JSession(jcfg, batch_size=BATCH, manual_seed=3,
                    mesh_shape=mesh_shape, **kw)


def _shape(sess, level):
    return (sess.pyramid.shape3d(level) if sess.ndim == 3
            else sess.pyramid.shape2d(level))


def _stage_noises(key, sess, dtype, start=0):
    """The JAX forward's draws (generators.py:174, 255-256): the
    reparameterization key, then one noise per noisy stage from
    ``start`` (every stage in 2D), in the stages' dtype."""
    key, k_rep = jax.random.split(key)
    noises = []
    for idx in range(SCALE):
        if idx >= start and (sess.ndim == 2
                             or sess.cfg.vae_levels <= idx + 1):
            key, k_n = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(
                k_n, (BATCH, *_shape(sess, idx + 1), 3), dtype)
                .astype(jnp.float32)))
        else:
            noises.append(None)
    return k_rep, noises


def _draws(psess, dtype):
    """Each mode's JAX inputs and keys, and the port's calls on the same
    draws."""
    noise = np.random.default_rng(41).standard_normal(
        psess.noise_shape).astype(np.float32)
    k_rand, k_rec, k_inj = (jax.random.PRNGKey(s) for s in (42, 43, 44))
    _, noises = _stage_noises(k_rand, psess, dtype)
    k_rep, _ = _stage_noises(k_rec, psess, dtype)
    eps = np.asarray(jax.random.normal(   # in mu's dtype (networks.py:48)
        k_rep, (BATCH, *_shape(psess, 0), psess.cfg.latent_dim), dtype)
        .astype(jnp.float32))
    _, inj_noises = _stage_noises(k_inj, psess, dtype, START)
    x_init = np.stack([psess.real_clip(START)] * BATCH)
    jax_in = {"rand": (noise, k_rand), "rec": k_rec,
              "inject": (x_init, k_inj)}
    calls = {"rand": ("rand", {"noise": noise, "noises": noises}),
             "rec": ("rec", {"eps": eps}),
             "inject": ("inject", {"x_init": x_init, "start": START,
                                   "noises": inj_noises})}
    return jax_in, calls


def _numpy_draws(psess):
    """Rand and rec calls of a ``GeneratorVAE_nb`` or baseline session on
    numpy draws (held against one process only)."""
    rng = np.random.default_rng(45)
    G = psess.G
    noise = rng.standard_normal(psess.noise_shape).astype(np.float32)
    if not psess.is_triple:   # rec reads the checkpointed Z_init
        noises = [None] + [rng.standard_normal(G._noise_shape(i, BATCH))
                           .astype(np.float32) for i in range(1, SCALE + 1)]
        return None, {"rand": ("rand", {"noise": noise, "noises": noises}),
                      "rec": ("rec", {})}
    h0 = (BATCH, *_shape(psess, 0))
    latents = (rng.standard_normal((BATCH, 1, 1, 1, psess.cfg.latent_dim))
               .astype(np.float32),
               rng.integers(0, 2, (*h0, 1)).astype(np.float32))
    noises = [rng.standard_normal((BATCH, *_shape(psess, i + 1), 3))
              .astype(np.float32) for i in range(SCALE)]
    eps = (rng.standard_normal((BATCH, 1, 1, 1, psess.cfg.latent_dim))
           .astype(np.float32), rng.uniform(size=(*h0, 1)).astype(np.float32))
    return None, {"rand": ("rand", {"noise": noise, "noises": noises,
                                    "latents": latents}),
                  "rec": ("rec", {"eps": eps})}


def _jax_calls(jsess, jax_in, modes):
    out = {}
    if "rand" in modes:
        noise, key = jax_in["rand"]
        if jsess.mesh is not None:
            noise = shard_batch(jnp.asarray(noise), jsess.mesh, jsess.ndim)
        out["rand"] = jsess.sample_fn(jsess.gvars, noise, key)
    if "rec" in modes:
        out["rec"] = jsess.reconstruct_fn(jsess.gvars,
                                          jsess.rec_input()[0],
                                          jax_in["rec"])
    if "inject" in modes:
        x_init, key = jax_in["inject"]
        out["inject"] = jsess.inject_fn(jsess.gvars, x_init, key, START)
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in out.items()}


# name -> (source kind, extra config, session kwargs, modes, JAX meshes).
# The bf16, extrapolated and 2D one-process sessions are held against the
# JAX package in tests/test_torch_port_bf16_models.py,
# test_torch_port_sampling.py and test_torch_port_train_image.py; here
# they are held against one process (a JAX session of another config
# costs some 13 s of compiles on the CPU)
CASES = {
    "f32": ("video", {}, {}, ("rand", "rec", "inject"), MESH_SHAPES),
    "bf16": ("video", {"bf16": True}, {}, ("rand", "rec"), []),
    "h2": ("video", {}, {"h_factor": 2.0}, ("rand",), []),
    "2d": ("image", {}, {}, ("rand", "inject"), []),
    "vae_nb": ("video", {"generator": "GeneratorVAE_nb"}, {},
               ("rand", "rec"), []),
    "csg": ("video", {"generator": "GeneratorCSG"}, {}, ("rand", "rec"),
            []),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs by mesh and case; the one-process port's and
    the JAX sessions' outputs of the same calls."""
    base = tmp_path_factory.mktemp("mesh_sampling")
    clip = make_clip(base)
    image = make_image(base)
    netGs = {}
    for name, (kind, extra, _, _, _) in CASES.items():
        if name in ("vae_nb", "csg"):
            source, ndim, model = {"video_path": clip}, 3, SMALL
        elif kind == "video":
            source, ndim, model = {"video_path": clip}, 3, WIDE
        else:
            source, ndim, model = {"image_path": image}, 2, SMALL
        if name == "h2":
            netGs[name] = netGs["f32"]
            continue
        netGs[name] = _write_experiment(str(base / name), source, ndim,
                                        **model, **extra)
    sessions, cases, jax_in = {}, {}, {}
    for name, (_, extra, kw, modes, _) in CASES.items():
        psess = port_session(netGs[name], **kw)
        dtype = jnp.bfloat16 if extra.get("bf16") else jnp.float32
        jax_in[name], calls = (_numpy_draws(psess) if "generator" in extra
                               else _draws(psess, dtype))
        sessions[name] = psess
        cases[name] = {"netG": netGs[name], "session": kw,
                       "calls": [calls[m] for m in modes]}
    torch.save(cases, base / "sampling.pt")
    groups = {w: start_ranks("sampling", w, base) for w in (2, 4)}

    # meanwhile: the one-process port and the JAX sessions
    single = {name: session_calls(sessions[name], cases[name]["calls"])
              for name in CASES}
    jax_ref = {}
    for name, (_, _, kw, modes, meshes) in CASES.items():
        for shape in meshes:
            jsess = _jax_session(netGs[name], "x".join(map(str, shape)),
                                 **kw)
            ref = _jax_calls(jsess, jax_in[name], modes)
            jax_ref[(shape, name)] = [ref[m] for m in modes]

    for procs in groups.values():
        wait_ranks(procs)
    sharded = {}
    for world in groups:
        for rank_out in results("sampling", world, base):
            for key, value in rank_out.items():
                sharded.setdefault(key, []).append(value)
    return sharded, single, jax_ref


def _close(got, want, bf16):
    if bf16:
        err = float(np.max(np.abs(got - want)))
        assert err <= BF16_BAR * max(1.0, float(np.max(np.abs(want)))), err
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_samples_equal_one_process_and_jax(runs, mesh_shape,
                                                   name):
    sharded, single, jax_ref = runs
    bf16 = bool(CASES[name][1].get("bf16"))
    outs = sharded[(mesh_shape, name)]
    assert len(outs) == mesh_shape[0] * mesh_shape[1]
    for rank_out in outs:
        for got, want in zip(rank_out["outs"], single[name]):
            assert got.shape == want.shape and got.dtype == np.float32
            _close(got, want, bf16)
    for shape in CASES[name][4]:
        for got, want in zip(outs[0]["outs"], jax_ref[(shape, name)]):
            _close(got, want, bf16)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_every_stage_conv_ran_k4_on_the_ranks_block(runs, mesh_shape):
    """``pconv_all``: the stage convs of every rank ran K4's composition
    (its plain K1 on the CPU), the same number of times on each rank:
    ``num_layer`` 64 -> 64 convs a stage, ``SCALE`` stages in rand and
    rec, ``SCALE - START`` in inject; the spatial ranks' blocks tile the
    top scale's H."""
    outs = runs[0][(mesh_shape, "f32")]
    calls = {o["k4"] for o in outs}
    assert calls == {WIDE["num_layer"] * (3 * SCALE - START)}
    blocks = [o["block"] for o in outs[:mesh_shape[1]]]
    assert blocks[0][0] == 0 and blocks[-1][1] == 12
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


@pytest.mark.parametrize("mesh_shape", [s for s in MESH_SHAPES if s[0] > 1])
def test_a_batch_the_data_axis_does_not_divide_raises(runs, mesh_shape):
    for message in runs[0][(mesh_shape, "odd_batch")]:
        assert message == (f"a batch of 3 does not split over the "
                           f"{mesh_shape[0]}-way data axis")
