"""A JAX ``netG_mid`` resumes in the port (``utils/saver.apply_resume``,
``load_mid_critic``, ``load_mid_optimizers``; ``train/optim.
load_jax_g_state``/``load_jax_d_state``; ``utils/convert.
generator_moments``/``critic_moments``).

A tiny JAX run (the JAX package's jitted steps on a seeded model, at the
default ``--grad-clip 5``, whose optax chain puts the clip's empty state
before the grouped Adam) takes one step and writes its ``netG_mid``
through the JAX package's own ``Saver`` (flax msgpack, the payload of
``trainer.py:371-377``): at a GAN scale, plain and under
``--fast-grads``, and at a VAE-phase scale (empty ``dvars``/``opt_d``).
The port loads it; then one port step and one JAX step from that state,
on the same injected draws, end with the same weights, Adam moments and
step counts at the f32 bar (``tests/torch_port_fast.py``).  The same
file resumes the port's CLI mid-scale to the end of the run."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.utils.saver import Saver as JSaver
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import make_generator
from hpvaegan_tpu_torch.train import optim, steps
from hpvaegan_tpu_torch.utils.saver import (apply_resume, load_mid_critic,
                                            load_mid_optimizers)
from torch_port_runs import TINY, experiment, make_clip, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _write_mid(tmp_path, jcfg, scale, gvars, opt_g, dvars, opt_d, amps):
    """The JAX trainer's ``netG_mid`` payload through the JAX saver."""
    jcfg.run_dir = str(tmp_path)
    saver = JSaver(jcfg, "clip")
    saver.save_checkpoint(
        {"scale": scale, "iteration": 1, "gvars": gvars, "opt_g": opt_g,
         "dvars": dvars if dvars is not None else {},
         "opt_d": opt_d if opt_d is not None else {},
         "noise_amps": np.asarray(amps, np.float32)}, "netG_mid",
        blocking=True)
    return os.path.join(saver.experiment_dir, "netG_mid")


def _merged(opt_state, template, field):
    """A JAX generator state's Adam ``field`` (``mu``/``nu``) merged over
    the label groups into one params view (zeros where no group holds a
    leaf)."""
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    leaves, treedef = jax.tree_util.tree_flatten(template)
    merged = [np.zeros_like(np.asarray(a)) for a in leaves]
    for adam in adams:
        flat = jax.tree_util.tree_flatten(
            getattr(adam, field),
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for i, leaf in enumerate(flat):
            if not isinstance(leaf, optax.MaskedNode):
                merged[i] = np.asarray(leaf)
    return jax.tree_util.tree_unflatten(treedef, merged), int(adams[0].count)


def _assert_adam_matches(opt, module, want_named, field, count):
    names = {id(p): n for n, p in module.named_parameters()}
    key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[field]
    n = 0
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            fast.close(state[key].cpu().numpy(),
                       want_named[names[id(p)]].detach().numpy(),
                       f"{names[id(p)]} {key}")
            assert float(state["step"]) == count
            n += 1
    assert n > 0


def _assert_generator_state(G, opt_g, gvars_new, opt_g_new, scale, over,
                            lr_max):
    _, ref = fast.port_generator(fast.np_tree(gvars_new), scale, **over)
    fast.assert_buffers_close(G, ref)
    fast.assert_params_after_adam(G, ref, lr_max)
    template = joptim.gparams_view(fast.np_tree(gvars_new))
    for field in ("mu", "nu"):
        moment, count = _merged(opt_g_new, template, field)
        _, m = fast.port_generator(
            joptim.merge_gparams(fast.np_tree(gvars_new), moment), scale,
            **over)
        _assert_adam_matches(opt_g, G, dict(m.named_parameters()), field,
                             count)


def _port_resume(path, over):
    cfg = fast.cfg_of(Config, **over)
    cfg.netG = path
    G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    apply_resume(cfg, G)
    G.requires_grad_(True)
    return cfg, G, cfg._mid_raw


@pytest.mark.parametrize("fast_grads", [False, True])
def test_a_gan_scale_netG_mid_continues_as_the_jax_run(tmp_path,
                                                        fast_grads):
    scale, over = 3, dict(fast_grads=fast_grads)
    jcfg, jG, gvars = fast.jax_generator(scale, **over)
    assert jcfg.grad_clip == 5.0
    jD, dvars, port_critic = fast.critics(3)
    fns, opt_g, opt_d, lrs = fast.jax_steps(jcfg, jG, jD, gvars, scale,
                                            dvars)
    cfg0 = fast.cfg_of(Config, **over)
    pyr = cfg0.pyramid()
    amps = fast.AMPS[:scale + 1]
    real, real_zero, noise_init = fast.data(pyr, 3, scale, seed=41)
    gvars, dvars, opt_g, opt_d, _ = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g, opt_d, real,
        real_zero, noise_init, jnp.asarray(amps), jax.random.PRNGKey(42))
    path = _write_mid(tmp_path, jcfg, scale, gvars, opt_g, dvars, opt_d,
                      amps)

    cfg, G, mid = _port_resume(path, over)
    assert mid["from_jax"] and cfg.resume_iteration == 1
    assert cfg.scale_idx == scale and len(G.body) == scale
    np.testing.assert_allclose(cfg.Noise_Amps, amps, rtol=1e-6)
    D = port_critic()
    D.reset_parameters(torch.Generator().manual_seed(9))
    load_mid_critic(D, mid)
    opt_d_port = optim.build_d_optimizer(cfg, D)
    opt_g_port = optim.build_g_optimizer(cfg, G, scale)
    load_mid_optimizers(mid, cfg, G, opt_g_port, D, opt_d_port)
    if fast_grads:
        optim.freeze_frozen(cfg, G, scale)

    real, real_zero, noise_init = fast.data(pyr, 3, scale, seed=43)
    key = jax.random.PRNGKey(44)
    gv2, dv2, opt_g2, opt_d2, metrics_ref = fns["gan_step"](
        fast.copy_tree(gvars), fast.copy_tree(dvars), opt_g, opt_d, real,
        real_zero, noise_init, jnp.asarray(amps), key)
    k_fake, k_gp, k_rec = jax.random.split(key, 3)
    metrics = steps.gan_step(
        G, D, opt_g_port, opt_d_port, cfg, real, real_zero, noise_init,
        amps, noises=fast.noises_of(k_fake, pyr, 3, scale,
                                    lambda i: cfg.vae_levels <= i + 1),
        eps=fast.eps_of(k_rec, pyr, 3),
        alpha=float(jax.random.uniform(k_gp, ())))
    fast.assert_metrics_close(metrics, metrics_ref)
    _assert_generator_state(G, opt_g_port, gv2, opt_g2, scale, over,
                            max(lrs.values()))
    ref_d = port_critic(fast.np_tree(dv2))
    fast.assert_params_after_adam(D, ref_d, cfg.lr_d)
    fast.assert_buffers_close(D, ref_d)
    for field in ("mu", "nu"):
        moment = getattr(opt_d2[0], field)
        m = port_critic({**fast.np_tree(dv2),
                         "params": fast.np_tree(moment)})
        _assert_adam_matches(opt_d_port, D, dict(m.named_parameters()),
                             field, int(opt_d2[0].count))


def test_a_vae_scale_netG_mid_continues_as_the_jax_run(tmp_path):
    """At a VAE-phase scale the payload's critic and its state are empty;
    the generator's state (the encoder and decoder training) loads."""
    scale, over = 1, {}
    jcfg, jG, gvars = fast.jax_generator(scale, **over)
    fns, opt_g, _, lrs = fast.jax_steps(jcfg, jG, None, gvars, scale)
    pyr = fast.cfg_of(Config).pyramid()
    amps = fast.AMPS[:scale + 1]
    real, real_zero, _ = fast.data(pyr, 3, scale, seed=45)
    gvars, opt_g, _ = fns["vae_step"](fast.copy_tree(gvars), opt_g, real,
                                      real_zero, jnp.asarray(amps),
                                      jax.random.PRNGKey(46))
    path = _write_mid(tmp_path, jcfg, scale, gvars, opt_g, None, None, amps)

    cfg, G, mid = _port_resume(path, over)
    assert mid["dvars"] == {} and mid["opt_d"] == {}
    opt_g_port = optim.build_g_optimizer(cfg, G, scale)
    load_mid_optimizers(mid, cfg, G, opt_g_port)
    real, real_zero, _ = fast.data(pyr, 3, scale, seed=47)
    key = jax.random.PRNGKey(48)
    gv2, opt_g2, metrics_ref = fns["vae_step"](
        fast.copy_tree(gvars), opt_g, real, real_zero, jnp.asarray(amps),
        key)
    metrics = steps.vae_step(G, opt_g_port, cfg, real, real_zero, amps,
                             eps=fast.eps_of(key, pyr, 3))
    fast.assert_metrics_close(metrics, metrics_ref)
    _assert_generator_state(G, opt_g_port, gv2, opt_g2, scale, over,
                            max(lrs.values()))


def test_a_jax_netG_mid_resumes_the_port_cli(tmp_path):
    """The port CLI resumes from a JAX ``netG_mid`` at its iteration and
    trains to the last scale (the rest of the run is the port's)."""
    jcfg, jG, gvars = fast.jax_generator(4)
    jD, dvars, _ = fast.critics(3)
    fns, opt_g, opt_d, _ = fast.jax_steps(jcfg, jG, jD, gvars, 4, dvars)
    amps = [1.0, 0.3, 0.2, 0.15, 0.1]
    path = _write_mid(tmp_path / "jax", jcfg, 4, gvars, opt_g, dvars, opt_d,
                      amps)
    clip = make_clip(tmp_path)
    seen = []
    from hpvaegan_tpu_torch.cli import train_video
    from hpvaegan_tpu_torch.utils.logger import kept_logging
    with kept_logging():
        train_video.main(["--video-path", clip, *TINY, "--run-dir",
                          str(tmp_path / "port"), "--netG", path],
                         callback=lambda s, e, i, m: seen.append((s, e, i)))
    assert [x for x in seen if x[1] == "step"] == [(4, "step", 1)]
    raw = torch.load(os.path.join(experiment(tmp_path / "port"), "netG"),
                     map_location="cpu", weights_only=True)
    assert raw["scale"] == 4 and len(raw["noise_amps"]) == 5
    assert all(torch.isfinite(v.float()).all()
               for v in raw["gvars"].values())
