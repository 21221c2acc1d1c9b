"""The sharded training step: ``vae_step`` and ``gan_step`` of the port
under ``--pconv --pconv-all`` on (data, spatial) meshes (1, 2), (2, 1) and
(2, 2) of gloo CPU ranks, against the single-process port step and the
JAX package's jitted step, from the same weights and JAX's draws, on the
tiny nfc-64 pyramid of tests/test_torch_port_train_step.py (stage heights
4, 5, 6, 7: the 2-way spatial axis leaves 5 and 7 uneven).

Bars (those of tests/test_torch_port_train_step.py): losses, BatchNorm
statistics and spectral u/v at the f32 default rtol 2e-3 / atol 2e-4
(errG and the total read the critic after its Adam step: they may move
further, by the first-order effect of the measured difference between
the two updated critics, ``sum |d errG / d theta| * |delta theta|``);
the gradients that reach Adam (summed over the mesh) against the
single-process port's at the same bar; parameters after one step within
``2 * lr`` of the reference's (Adam's first step is about
``lr * sign(g)``, so a gradient near 0 may take the other sign), at most
0.5% of the elements beyond the f32 bar.  The ranks' parameters must be
the same bit for bit, and every rank must have run K4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils import convert
from test_torch_port_train_step import (AMPS, ATOL, GAN_SCALE, RTOL, TINY,
                                        VAE_SCALE, _assert_buffers_close,
                                        _assert_params_after_adam, _copy,
                                        _data, _eps_of, _jax_steps,
                                        _noises_of, _np, _port_critic,
                                        _port_generator, jax_models)
from torch_port_ranks import (MESHES, record_grads, results, start_ranks,
                              wait_ranks)

MESH_SHAPES = [shape for world in (2, 4) for shape in MESHES[world]]
_ = jax_models   # the JAX weights, a fixture of the train-step tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _critic(dvars):
    """The critic as a mesh runs it: K1 body convs, no K2 pair."""
    D = WDiscriminator(3, 64, 3, TINY["num_layer"], ndim=3, pconv=True)
    convert.load_discriminator(D, dvars)
    return D


@pytest.fixture(scope="module")
def runs(jax_models, tmp_path_factory):
    """The sharded ranks' results by mesh and step, and the single-process
    port's and JAX's of the same steps."""
    jcfg, jG, gv, jD, dvars = jax_models
    cfg, G_vae = _port_generator(gv[VAE_SCALE], VAE_SCALE)
    _, G_gan = _port_generator(gv[GAN_SCALE], GAN_SCALE)
    pyr = cfg.pyramid()
    vae_key, gan_key = jax.random.PRNGKey(22), jax.random.PRNGKey(23)
    k_fake, k_gp, k_rec = jax.random.split(gan_key, 3)
    real, real_zero = _data(pyr, GAN_SCALE, seed=3)
    inp = {
        "cfg": dict(TINY), "ar": cfg.ar, "org_fps": cfg.org_fps,
        "vae_scale": VAE_SCALE, "gan_scale": GAN_SCALE,
        f"G{VAE_SCALE}": G_vae.state_dict(),
        f"G{GAN_SCALE}": G_gan.state_dict(),
        "D": _critic(dvars).state_dict(),
        "vae_data": _data(pyr, VAE_SCALE, seed=2),
        "vae_amps": AMPS[:VAE_SCALE + 1],
        "vae_eps": _eps_of(vae_key, pyr, cfg.latent_dim),
        "gan_data": (real, real_zero, np.random.default_rng(4)
                     .standard_normal((2, *pyr.shape3d(0), cfg.latent_dim))
                     .astype(np.float32)),
        "gan_amps": AMPS[:GAN_SCALE + 1],
        "gan_noises": _noises_of(k_fake, pyr, cfg.vae_levels, GAN_SCALE),
        "gan_eps": _eps_of(k_rec, pyr, cfg.latent_dim),
        "gan_alpha": float(jax.random.uniform(k_gp, ())),
    }
    d = tmp_path_factory.mktemp("spmd_steps")
    torch.save(inp, d / "inputs.pt")
    groups = {w: start_ranks("steps", w, d) for w in (2, 4)}

    # meanwhile: the single-process port steps and the JAX steps
    single = {}
    grads = {}
    opt_g = record_grads(optim.build_g_optimizer(cfg, G_vae, VAE_SCALE),
                         G_vae, grads)
    metrics = steps.vae_step(G_vae, opt_g, cfg, *inp["vae_data"],
                             inp["vae_amps"], eps=inp["vae_eps"])
    single["vae"] = dict(metrics=metrics, grads=grads, G=G_vae)
    D = _critic(dvars)
    g_grads, d_grads = {}, {}
    opt_g = record_grads(optim.build_g_optimizer(cfg, G_gan, GAN_SCALE),
                         G_gan, g_grads)
    opt_d = record_grads(optim.build_d_optimizer(cfg, D), D, d_grads)
    metrics = steps.gan_step(G_gan, D, opt_g, opt_d, cfg, *inp["gan_data"],
                             inp["gan_amps"], noises=inp["gan_noises"],
                             eps=inp["gan_eps"], alpha=inp["gan_alpha"])
    single["gan"] = dict(metrics=metrics, grads=g_grads, d_grads=d_grads,
                         G=G_gan, D=D)

    single["gan"]["errG_grad"] = _errG_grad(gv[GAN_SCALE], D, cfg, inp)

    jax_ref = {}
    gvars = gv[VAE_SCALE]
    fns, opt_g_j, _, lrs = _jax_steps(jcfg, jG, None, gvars, VAE_SCALE)
    gv_new, _, m = fns["vae_step"](_copy(gvars), opt_g_j, *inp["vae_data"],
                                   jnp.asarray(inp["vae_amps"]), vae_key)
    jax_ref["vae"] = dict(metrics=m, lr=max(lrs.values()),
                          G=_port_generator(_np(gv_new), VAE_SCALE)[1])
    gvars = gv[GAN_SCALE]
    fns, opt_g_j, opt_d_j, lrs = _jax_steps(jcfg, jG, jD, gvars, GAN_SCALE,
                                            dvars)
    gv_new, dv_new, _, _, m = fns["gan_step"](
        _copy(gvars), _copy(dvars), opt_g_j, opt_d_j, *inp["gan_data"],
        jnp.asarray(inp["gan_amps"]), gan_key)
    jax_ref["gan"] = dict(metrics=m, lr=max(lrs.values()), lr_d=cfg.lr_d,
                          G=_port_generator(_np(gv_new), GAN_SCALE)[1],
                          D=_port_critic(_np(dv_new)))

    for procs in groups.values():
        wait_ranks(procs)
    sharded = {}
    for world in groups:
        for rank_out in results("steps", world, d):
            for key, value in rank_out.items():
                sharded.setdefault(key, []).append(value)
    return sharded, single, jax_ref


def _errG_grad(gvars, D, cfg, inp) -> dict:
    """``|d errG / d theta|`` for each parameter of the updated critic
    ``D``, by name, at the generator's pre-step weights."""
    import copy
    from hpvaegan_tpu_torch.models.generators import to_model_layout
    _, G = _port_generator(gvars, GAN_SCALE)
    real, real_zero, noise_init = inp["gan_data"]
    with torch.no_grad():
        fake, _, _ = G.apply(inp["gan_amps"], noise_init=noise_init,
                             mode="rand", train=True,
                             noises=inp["gan_noises"])
    D = copy.deepcopy(D)
    D.zero_grad(set_to_none=True)
    errG = -D(to_model_layout(fake)).mean() * cfg.disc_loss_weight
    errG.backward()
    return {n: p.grad.abs() for n, p in D.named_parameters()}


def _first_order(grad_abs: dict, D, D_other) -> float:
    """``sum |d errG / d theta| * |theta - theta_other|`` over the two
    critics' parameters."""
    other = dict(D_other.named_parameters())
    with torch.no_grad():
        return float(sum((grad_abs[n] * (p - other[n]).abs()).sum()
                         for n, p in D.named_parameters()))


def _module_like(module, state):
    """A copy of ``module`` holding ``state``."""
    import copy
    m = copy.deepcopy(module)
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("step", ["vae", "gan"])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_step_matches_single_process_and_jax(runs, mesh_shape,
                                                     step):
    sharded, single, jax_ref = runs
    rank0 = sharded[(mesh_shape, step)][0]
    ref, jref = single[step], jax_ref[step]
    D = (_module_like(ref["D"], rank0["d_state"]) if step == "gan"
         else None)
    for other in (ref, jref):
        # errG and the total read the critic after its Adam step, which
        # turns gradient noise near 0 (the critic tail's bias has an
        # exact gradient of 0) into parameter differences up to 2 * lr_d:
        # they are held to the f32 bar plus the first-order effect of the
        # two critics' measured difference
        moved = (_first_order(single["gan"]["errG_grad"], D, other["D"])
                 if step == "gan" else 0.0)
        for name, value in other["metrics"].items():
            extra = moved if name in ("errG", "loss") else 0.0
            got, want = rank0["metrics"][name], float(value)
            assert abs(got - want) <= ATOL + RTOL * abs(want) + extra, (
                name, got, want, extra)
    for key in ("grads", "d_grads") if step == "gan" else ("grads",):
        assert set(rank0[key]) == set(ref[key])
        for name, g in ref[key].items():
            np.testing.assert_allclose(rank0[key][name].numpy(), g.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key} {name}")
    G = _module_like(ref["G"], rank0["state"])
    for want in (ref["G"], jref["G"]):
        _assert_buffers_close(G, want)
        _assert_params_after_adam(G, want, jref["lr"])
    if step == "gan":
        for want in (ref["D"], jref["D"]):
            _assert_buffers_close(D, want)
            _assert_params_after_adam(D, want, jref["lr_d"])


@pytest.mark.parametrize("step", ["vae", "gan"])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_every_rank_holds_the_same_parameters_and_ran_k4(runs, mesh_shape,
                                                          step):
    """No broadcast after the step: the summed gradients keep the ranks'
    parameters, BatchNorm statistics and u/v equal bit for bit."""
    outs = runs[0][(mesh_shape, step)]
    assert len(outs) == mesh_shape[0] * mesh_shape[1]
    for o in outs[1:]:
        assert torch.equal(o["digest"], outs[0]["digest"])
        for key in ("state", "d_state"):
            for name, t in outs[0].get(key, {}).items():
                assert torch.equal(o[key][name], t), (key, name)
    # K4 ran every 64 -> 64 conv of the stages (and the critic's body)
    calls = {o["k4_calls"] for o in outs}
    assert len(calls) == 1 and calls.pop() > 0
