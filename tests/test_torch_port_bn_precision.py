"""How close the baselines' step gradients come to exact arithmetic: the
JAX package's f32 step and the port's default f32 step (BatchNorm through
``F.batch_norm``), each against the JAX step evaluated in float64 with
two-pass BatchNorm statistics (``exact_reference``), on the CSG and SG
cases of tests/test_torch_port_mesh_models.py; and the port on a 1x1
mesh (its own two-pass statistics through ``Mesh.gather_rows``).

Two measures over the generator's parameters that train, G being the
largest ``|g64|`` among them: the relative error, the largest ``max |g -
g64| / max |g64|`` over the parameters whose exact gradient is not zero
(``max |g64| > 1e-6 G``); and the noise, ``max |g| / G`` over those whose
exact gradient is zero (a conv bias right before a BatchNorm, which the
normalisation cancels: its value changes no output).  The port's default
step must be no further from float64 than the JAX package's own f32 step
in the first, and leave its zero gradients below 1e-3 G as JAX's does:
the one-process BatchNorm backward is not the weaker link.  Run with
``-s`` to print the measures and the parameters they come from (the
port on a 1x1 mesh for comparison)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_baselines as tb
import test_torch_port_mesh_models as tm
import torch_port_fast as fast
import torch_port_flax as flax_vars
from hpvaegan_tpu.models.registry import make_discriminator as jmake_d
from hpvaegan_tpu.train import optim as joptim
from hpvaegan_tpu.train.steps import make_baseline_steps
from hpvaegan_tpu_torch.models.registry import make_discriminator
from hpvaegan_tpu_torch.utils import convert
from torch_port_ranks import run_model_case
from torch_port_runs import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _errors(got: dict, exact: dict):
    """((relative error, its parameter), (noise, its parameter)) over the
    parameters that train (``got``'s)."""
    top = max(float(exact[n].abs().max()) for n in got)
    rel, noise = (0.0, "none"), (0.0, "none")
    for n, g in got.items():
        scale = float(exact[n].abs().max())
        if scale > 1e-6 * top:
            d = float((g.double() - exact[n].double()).abs().max())
            rel = max(rel, (d / scale, n))
        else:
            noise = max(noise, (float(g.abs().max()) / top, n))
    return rel, noise


@pytest.mark.parametrize("name", list(tm.BASELINES))
def test_the_port_step_is_no_further_from_float64_than_jax(name):
    generator, extra = tm.BASELINES[name]
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

    def jax_grads(exact: bool):
        """The JAX step's generator gradients (Adam's first moments over
        1 - beta1; no clip), by the port's parameter names, and its stage
        noises."""
        cast = tb._f64 if exact else (lambda t: t)
        with tb.exact_reference() if exact else contextlib.nullcontext():
            gv, dv = cast(gvars), cast(dvars)
            ml, bl, lrs = joptim.baselines_group_plan(
                jcfg, tb.SCALE, tb.SCALE + 1, jG.has_head_tail)
            tx_g, opt_g = joptim.build_g_optimizer(
                jcfg, joptim.gparams_view(gv), ml, bl, lrs, grad_clip=None)
            tx_d, opt_d = joptim.build_d_optimizer(jcfg, dv["params"])
            fns = make_baseline_steps(jG, jD, jcfg, tx_g, tx_d)
            _, _, opt_g, _, _ = fns["step"](
                gv, dv, opt_g, opt_d, *cast((real, noise_init, z_init)),
                jnp.asarray(tb.AMPS, jnp.float64 if exact else jnp.float32),
                key)
            mu = fast.jax_first_moments(opt_g, joptim.gparams_view(gv))
            noises = (tb._stage_noises_f64(key, G) if exact
                      else tb._stage_noises(key, G))
        grads = jax.tree_util.tree_map(
            lambda a: (np.asarray(a, np.float64)
                       / (1 - jcfg.beta1)).astype(np.float32), mu)
        return convert.generator_moments(G, gvars, grads), noises

    exact, noises = jax_grads(True)
    jax_f32, _ = jax_grads(False)
    alpha = float(jax.random.uniform(jax.random.fold_in(
        jax.random.fold_in(key, 0), 0), ()))
    case = tm._case({**tb.TINY, "generator": generator, **over}, tb.SCALE,
                    "baseline", G, D, data=(real, noise_init, z_init),
                    amps=tb.AMPS,
                    noises=[None if n is None else n.astype(np.float32)
                            for n in noises], alphas=[alpha])
    errors = {"JAX f32": _errors(jax_f32, exact),
              "port": _errors(run_model_case(case)["grads"], exact),
              "port, 1x1 mesh": _errors(
                  run_model_case(case, tm.ONE)["grads"], exact)}
    print(f"\n{name} against float64: " + "; ".join(
        f"{k}: relative error {r:.3e} ({rn}), zero-gradient noise "
        f"{z:.3e} ({zn})" for k, ((r, rn), (z, zn)) in errors.items()))
    assert errors["port"][0][0] <= errors["JAX f32"][0][0]
    assert errors["port"][1][0] < 1e-3 and errors["JAX f32"][1][0] < 1e-3
