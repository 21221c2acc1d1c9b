"""The generators that a mesh used to refuse, trained over (data, spatial)
meshes (1, 2), (2, 1) and (2, 2) of gloo CPU ranks
(``tests/torch_port_ranks.py`` ``run_model_case``, each group started
once for the module), against the one-process port and the JAX
package's jitted steps, from the same weights (seeded port models as
flax trees, ``torch_port_flax``) and JAX's draws:

* ``GeneratorVAE_nb``'s ``vae_step`` (nfc 8, scale 1) and ``gan_step``
  (nfc 64 under ``--pconv --pconv-all``, scale 3, so the stages and the
  critic's body run K4): its pooled ``mu``/``logvar`` summed over the
  spatial ring;
* the baselines' ``baseline_step``: ``GeneratorCSG`` (``num_layer`` 3)
  with the SN critic and ``GeneratorSG`` (``num_layer`` 2) with
  ``WDiscriminatorBaselines``, at scale 2.  Their VALID convs and zero
  padding run on windows of the whole H.

The tiny geometry (ar 0.5625) gives stage heights 4, 5, 6, 7: over the
2-way spatial axis H = 5 and 7 are uneven, and scale 0's blocks of 2 rows
are shorter than the shrink of a CSG stage (3) and of an SG stage (4).
Last, ``cli.train_video_baselines --spmd --mesh-shape 1x2 --no-cuda``
and ``cli.train_video --generator GeneratorVAE_nb --spmd --mesh-shape
1x2`` train.

Bars (tests/test_torch_port_spmd_steps.py's): losses, BatchNorm
statistics and spectral u/v at the f32 default ``rtol=2e-3, atol=2e-4``
(errG and the total read the critic after its Adam step: they may move
further by the first-order effect of the two updated critics'
difference); the gradients that reach Adam at the same bar; the
parameters after the step within ``2 * lr`` of the reference's, at most
0.5% of the elements beyond the f32 bar; the ranks' parameters equal bit
for bit.

The baselines' gradients are held against the one-process step run on
a 1x1 mesh (the same arithmetic, one process): the default one-process
step computes its BatchNorm with ``F.batch_norm``, and on the CPU its
generator gradients in the last CSG stage differ from a float64 run of
the step by up to 1.3% of their largest value, where the mesh's
BatchNorm (sum and sum of squares) agrees with the float64 run to 5e-7
(measured on these inputs).  Its metrics and parameters are held
against the default one-process step and JAX as the others are."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.models.networks import WDiscriminator as JCritic
from hpvaegan_tpu.models.registry import make_discriminator as jmake_d
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_baseline_steps
from hpvaegan_tpu_torch.cli import train_video, train_video_baselines
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.generators import to_model_layout
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.parallel.mesh import Mesh
from hpvaegan_tpu_torch.utils import convert
from hpvaegan_tpu_torch.utils.logger import kept_logging
import test_torch_port_baselines as tb
import test_torch_port_vae_nb as tnb
import torch_port_flax as flax_vars
from torch_port_ranks import (MESHES, results, run_model_case, start_ranks,
                              wait_ranks)
from torch_port_runs import experiment, make_clip, one_torch_thread

RTOL, ATOL = 2e-3, 2e-4
MESH_SHAPES = [shape for world in (2, 4) for shape in MESHES[world]]
NB_WIDE = dict(nfc=64, pconv=True, pconv_all=True,
               discriminator="WDiscriminator3D")
BASELINES = {"csg": ("GeneratorCSG", dict(
                 num_layer=3, discriminator="WDiscriminatorBaselines")),
             "sg": ("GeneratorSG", dict(discriminator="WDiscriminator3D"))}
CASES = ["nb_vae", "nb_gan", "csg", "sg"]
ONE = Mesh((1, 1), 0, 0, 0, (0,), None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _case(over, scale, step, G, D=None, **rest) -> dict:
    return dict(cfg=over, ar=0.5625, org_fps=24.0, scale=scale,
                stages=len(G.body), step=step, G=G.state_dict(),
                D=None if D is None else D.state_dict(), **rest)


def _nb_cases():
    """``GeneratorVAE_nb``'s two steps: the cases, and JAX's results."""
    cases, jax_ref = {}, {}
    scale = 1
    jcfg, jG, gvars = tnb._jax_model(scale)
    fns, opt_g_j, _, lrs = tnb._jax_steps(jcfg, jG, None, gvars, scale)
    cfg, G = tnb._port_model(gvars)
    pyr = cfg.pyramid()
    real, real_zero = tnb._data(pyr, scale, seed=51)
    key = jax.random.PRNGKey(52)
    amps = tnb.AMPS[:scale + 1]
    gv_new, _, metrics = fns["vae_step"](tnb._copy(gvars), opt_g_j, real,
                                         real_zero, jnp.asarray(amps), key)
    cases["nb_vae"] = _case(dict(tnb.TINY), scale, "vae", G,
                            data=(real, real_zero), amps=amps,
                            eps=tnb._rec_eps(key, pyr, cfg.latent_dim))
    jax_ref["nb_vae"] = dict(metrics=metrics, lr=max(lrs.values()),
                             G=tnb._port_model(tnb._np(gv_new))[1])

    scale = tnb.SCALE
    jcfg, jG, gvars = tnb._jax_model(scale, **NB_WIDE)
    jD = JCritic(nfc=64, ker_size=3, num_layer=jcfg.num_layer, ndim=3)
    D0 = make_discriminator("WDiscriminator3D", tnb._cfg(Config, **NB_WIDE),
                            3)
    D0.reset_parameters(torch.Generator().manual_seed(53))
    dvars = flax_vars.critic(D0)
    fns, opt_g_j, opt_d_j, lrs = tnb._jax_steps(jcfg, jG, jD, gvars, scale,
                                                dvars)
    cfg, G = tnb._port_model(gvars, **NB_WIDE)
    pyr = cfg.pyramid()
    real, real_zero = tnb._data(pyr, scale, seed=54)
    noise_init = np.random.default_rng(55).standard_normal(
        (tnb.BATCH, *pyr.shape3d(0), cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(56)
    amps = tnb.AMPS[:scale + 1]
    gv_new, dv_new, _, _, metrics = fns["gan_step"](
        tnb._copy(gvars), tnb._copy(dvars), opt_g_j, opt_d_j, real,
        real_zero, noise_init, jnp.asarray(amps), key)
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    latents, noises = tnb._rand_draws(k_fake, pyr, cfg.latent_dim, scale)
    cases["nb_gan"] = _case(
        {**tnb.TINY, **NB_WIDE}, scale, "gan", G, D0,
        data=(real, real_zero, noise_init), amps=amps, noises=noises,
        latents=latents, eps=tnb._rec_eps(k_rec, pyr, cfg.latent_dim),
        alpha=float(jax.random.uniform(k_gp, ())))
    D_ref = copy.deepcopy(D0)
    convert.load_discriminator(D_ref, tnb._np(dv_new))
    jax_ref["nb_gan"] = dict(metrics=metrics, lr=max(lrs.values()),
                             lr_d=cfg.lr_d, D=D_ref,
                             G=tnb._port_model(tnb._np(gv_new), **NB_WIDE)[1])
    return cases, jax_ref


def _baseline_cases():
    """The CSG and SG steps: the cases, and JAX's results, the JAX step
    evaluated exactly (``exact_reference``: float64, two-pass BatchNorm
    statistics; its f32 run loses digits where the critic's zero padding
    dominates a batch, tests/test_torch_port_baselines.py) on its float64
    draws."""
    cases, jax_ref = {}, {}
    for name, (generator, extra) in BASELINES.items():
        over = dict(Dsteps=1, Gsteps=1, alpha=10.0, **extra)
        jcfg, jG, gvars, cfg, G = tb._models(generator, **over)
        cfg.scale_idx = jcfg.scale_idx = tb.SCALE
        pyr = cfg.pyramid()
        D = make_discriminator(cfg.discriminator, cfg, 3)
        D.reset_parameters(torch.Generator().manual_seed(57))
        dvars = flax_vars.critic(D)
        jD = jmake_d(cfg.discriminator, jcfg, 3)
        real = tb._x((tb.BATCH, *pyr.shape3d(tb.SCALE), 3), 58)
        rng = np.random.default_rng(59)
        noise_init = rng.standard_normal(
            (tb.BATCH, *pyr.shape3d(0), 3)).astype(np.float32)
        z_init = rng.standard_normal(noise_init.shape).astype(np.float32)
        key = jax.random.PRNGKey(60)
        with tb.exact_reference():
            gv64, dv64 = tb._f64(gvars), tb._f64(dvars)
            ml, bl, lrs = joptim.baselines_group_plan(
                jcfg, tb.SCALE, tb.SCALE + 1, jG.has_head_tail)
            tx_g, opt_g_j = joptim.build_g_optimizer(
                jcfg, joptim.gparams_view(gv64), ml, bl, lrs, grad_clip=None)
            tx_d, opt_d_j = joptim.build_d_optimizer(jcfg, dv64["params"])
            fns = make_baseline_steps(jG, jD, jcfg, tx_g, tx_d)
            gv_new, dv_new, _, _, metrics = fns["step"](
                gv64, dv64, opt_g_j, opt_d_j, *tb._f64((real, noise_init,
                                                        z_init)),
                jnp.asarray(tb.AMPS, jnp.float64), key)
            noises = tb._stage_noises_f64(key, G)
            k_gp = jax.random.fold_in(key, 0)
            alpha = float(jax.random.uniform(jax.random.fold_in(k_gp, 0),
                                             ()))
            gv_new, dv_new, metrics = (
                jax.tree_util.tree_map(np.asarray, t)
                for t in (gv_new, dv_new, metrics))
        cases[name] = _case(
            {**tb.TINY, "generator": generator, **over}, tb.SCALE,
            "baseline", G, D, data=(real, noise_init, z_init), amps=tb.AMPS,
            noises=[None if n is None else n.astype(np.float32)
                    for n in noises], alphas=[alpha])
        G_ref = make_generator(generator, cfg, pyr, ndim=3).init()
        while len(G_ref.body) < len(G.body):
            G_ref.init_next_stage()
        convert.load_generator(G_ref, jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), gv_new))
        D_ref = copy.deepcopy(D)
        convert.load_discriminator(D_ref, jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), dv_new))
        jax_ref[name] = dict(metrics=metrics, lr=max(lrs.values()),
                             lr_d=cfg.lr_d, G=G_ref, D=D_ref)
    return cases, jax_ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results by mesh and case, and the one-process port's
    (by default and on a 1x1 mesh) and JAX's of the same steps."""
    d = tmp_path_factory.mktemp("mesh_models")
    nb, nb_ref = _nb_cases()
    bl, bl_ref = _baseline_cases()
    cases, jax_ref = {**nb, **bl}, {**nb_ref, **bl_ref}
    torch.save(cases, d / "models.pt")
    groups = {w: start_ranks("models", w, d) for w in (2, 4)}
    single = {name: run_model_case(case) for name, case in cases.items()}
    on_one = {name: run_model_case(cases[name], ONE) for name in BASELINES}
    for procs in groups.values():
        wait_ranks(procs)
    sharded = {}
    for world in groups:
        for rank_out in results("models", world, d):
            for key, value in rank_out.items():
                sharded.setdefault(key, []).append(value)
    return cases, sharded, single, on_one, jax_ref


def _modules(case, state=None, d_state=None):
    """The case's generator and critic, holding ``state``/``d_state``
    (the case's own weights by default)."""
    cfg = Config(**case["cfg"])
    cfg.ar, cfg.org_fps = case["ar"], case["org_fps"]
    cfg.adjust_scales()
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    while len(G.body) < case["stages"]:
        G.init_next_stage()
    G.load_state_dict(case["G"] if state is None else state)
    D = None
    if case["step"] != "vae":
        D = make_discriminator(cfg.discriminator, cfg, 3)
        D.load_state_dict(case["D"] if d_state is None else d_state)
    return cfg, G, D


def _errG_sensitivity(case, d_state) -> dict:
    """``|d errG / d theta|`` of the critic holding ``d_state``, at the
    generator's pre-step weights and the step's draws."""
    cfg, G, D = _modules(case, d_state=d_state)
    kw = {"noises": case["noises"]}
    if case["step"] == "gan":
        noise_init = case["data"][2]
        kw["noise_init_norm"], kw["noise_init_bern"] = case["latents"]
    else:
        noise_init = case["data"][1]
    with torch.no_grad():
        fake = G.apply(case["amps"], noise_init=noise_init, mode="rand",
                       train=True, **kw)
        fake = fake[0] if isinstance(fake, tuple) else fake
    errG = -D(to_model_layout(fake)).mean() * cfg.disc_loss_weight
    errG.backward()
    return {n: p.grad.abs() for n, p in D.named_parameters()}


def _first_order(grad_abs, D, D_other) -> float:
    other = dict(D_other.named_parameters())
    with torch.no_grad():
        return float(sum((grad_abs[n] * (p - other[n]).abs()).sum()
                         for n, p in D.named_parameters()))


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


def _assert_buffers_close(module, ref):
    want = dict(ref.named_buffers())
    for name, buf in module.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_step_matches_one_process_and_jax(runs, mesh_shape, name):
    cases, sharded, single, on_one, jax_ref = runs
    case, rank0 = cases[name], sharded[(mesh_shape, name)][0]
    one, jref = single[name], jax_ref[name]
    _, G, D = _modules(case, rank0["state"], rank0["d_state"] or None)
    if name in BASELINES:
        one = on_one[name]
    refs = [(one, _modules(case, one["state"], one["d_state"] or None)),
            (jref, (None, jref["G"], jref.get("D")))]
    sensitivity = (_errG_sensitivity(case, rank0["d_state"])
                   if D is not None else None)
    for ref, (_, G_ref, D_ref) in refs:
        moved = 0.0 if D is None else _first_order(sensitivity, D, D_ref)
        for metric, value in ref["metrics"].items():
            extra = moved if metric in ("errG", "loss") else 0.0
            got, want = rank0["metrics"][metric], float(value)
            assert abs(got - want) <= ATOL + RTOL * abs(want) + extra, (
                metric, got, want, extra)
        lr = jref["lr"] * case["cfg"].get("Gsteps", 1)
        _assert_buffers_close(G, G_ref)
        _assert_params_after_adam(G, G_ref, lr)
        if D is not None:
            _assert_buffers_close(D, D_ref)
            _assert_params_after_adam(D, D_ref, jref["lr_d"])
    grads_ref = on_one[name] if name in BASELINES else one
    for key in ("grads", "d_grads"):
        assert set(rank0[key]) == set(grads_ref[key])
        for param, g in grads_ref[key].items():
            np.testing.assert_allclose(rank0[key][param].numpy(), g.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key} {param}")


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_eval_mode_latents_are_drawn_whole(runs, mesh_shape):
    """``GeneratorVAE_nb`` in eval mode under a mesh: ``z_norm`` is the
    prior's draw and ``z_bern`` a Bernoulli sample of the whole gate, as
    one process draws them from the same generator (the rec forward
    before the VAE step)."""
    got = runs[1][(mesh_shape, "nb_vae")]
    want = runs[2]["nb_vae"]["evaluated"]
    for rank_out in got:
        np.testing.assert_allclose(rank_out["evaluated"].numpy(),
                                   want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_every_rank_holds_the_same_parameters(runs, mesh_shape, name):
    outs = runs[1][(mesh_shape, name)]
    assert len(outs) == mesh_shape[0] * mesh_shape[1]
    for o in outs[1:]:
        assert torch.equal(o["digest"], outs[0]["digest"])
        for key in ("state", "d_state"):
            for param, t in outs[0][key].items():
                assert torch.equal(o[key][param], t), (key, param)


# ---- the CLIs over a spatial axis ----

def _train(cli, clip, run_dir, *flags):
    with kept_logging():
        cli.main(["--video-path", clip, "--img-size", "16", "--min-size",
                  "8", "--max-size", "16", "--niter", "1", "--nfc", "8",
                  "--num-layer", "2", "--batch-size", "2", "--manualSeed",
                  "5", "--no-cuda", "--run-dir", str(run_dir), *flags])
    return experiment(run_dir)


@pytest.mark.parametrize("cli,flags", [
    (train_video_baselines, ["--generator", "GeneratorSG",
                             "--discriminator", "WDiscriminatorBaselines"]),
    (train_video, ["--generator", "GeneratorVAE_nb", "--latent-dim", "4",
                   "--enc-blocks", "1", "--vae-levels", "2"])])
def test_the_clis_train_over_a_spatial_axis(tmp_path, monkeypatch, cli,
                                            flags):
    """The CLI starts two gloo ranks, each with one block of H; rank 0
    writes the run's file set, whose weights are finite and within one
    Adam step a scale (``2 * lr``) of the one-process run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    clip = make_clip(tmp_path)
    one = _train(cli, clip, tmp_path / "one", *flags)
    two = _train(cli, clip, tmp_path / "two", *flags, "--spmd",
                 "--mesh-shape", "1x2")
    def files(exp):   # an event file's name holds its time
        return sorted("events" if n.startswith("events.out.tfevents") else n
                      for n in os.listdir(exp))
    assert files(two) == files(one)
    a, b = (torch.load(os.path.join(e, "netG"), map_location="cpu",
                       weights_only=True)["gvars"] for e in (one, two))
    assert set(a) == set(b)
    worst = max(float((a[k] - b[k]).abs().max()) for k in a)
    assert worst <= 5 * 2 * 0.0005 * 1.01, worst
