"""The memory ladder of the port (``train/fallback.py``), the counterpart
of tests/test_oom_fallback.py: plain -> ``--remat`` -> ``--gp-chunked``
-> ``--remat-blocks``, as far as needed and no further; an OOM with
every rung on propagates, and so does every error that is not a
``torch.OutOfMemoryError``.

The card raises its OOM in the middle of a step, so the ladder rolls the
step back before it retries.  Here an OOM is injected once by a
test-side patch at three places (the critic's forward, the gradient
penalty, and the generator step after the critic's Adam update): the
retried ``gan_step`` ends with the parameters, buffers and both
optimizers' states of a step that ran with ``--remat`` from the start.
The trainer's ladder (``train_scale``, and with ``--scan-steps 2``,
whose chunks loop on the CPU) retries a step or the calibration hit at
iteration 1 and ends equal to the run with the rung from the start."""
import logging

import numpy as np
import pytest
import torch

import torch_port_fast as fast
from hpvaegan_tpu_torch import losses
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.networks import WDiscriminator
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.train import fallback, optim, steps, trainer
from hpvaegan_tpu_torch.train.fallback import (Ladder, escalate, is_oom,
                                               oom_dispatch)
from torch_port_runs import one_torch_thread

SCALE = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _oom():
    return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                  "2.00 GiB")


def make_rebuild(fail_until):
    """steps whose 'step' raises an OOM until `fail_until` rungs are
    on."""
    calls = {"rebuilds": 0}

    def rungs_on(cfg):
        return sum([cfg.remat, cfg.remat_blocks, cfg.gp_chunked])

    def rebuild_for(cfg):
        def rebuild():
            calls["rebuilds"] += 1

            def step(x):
                if rungs_on(cfg) < fail_until:
                    raise _oom()
                return x + 1

            return {"step": step}
        return rebuild
    return rebuild_for, calls


@pytest.mark.parametrize("rungs_needed,expected", [
    (0, (False, False, False)),
    (1, (True, False, False)),
    (2, (True, True, False)),
    (3, (True, True, True)),
])
def test_ladder_escalates_exactly_as_needed(rungs_needed, expected, caplog):
    cfg = Config()
    rebuild_for, calls = make_rebuild(rungs_needed)
    dispatch = oom_dispatch(cfg, scale_idx=9, rebuild=rebuild_for(cfg))
    with caplog.at_level(logging.WARNING):
        assert dispatch("step", 41) == 42
    assert (cfg.remat, cfg.gp_chunked, cfg.remat_blocks) == expected
    assert calls["rebuilds"] == 1 + rungs_needed
    logged = [r.getMessage() for r in caplog.records
              if "does not fit" in r.getMessage()]
    assert len(logged) == rungs_needed
    assert all(m.startswith("scale 9: step does not fit HBM — enabling ")
               for m in logged)


def test_oom_with_all_rungs_on_reraises():
    cfg = Config()
    cfg.remat = cfg.remat_blocks = cfg.gp_chunked = True
    rebuild_for, _ = make_rebuild(fail_until=99)
    dispatch = oom_dispatch(cfg, 9, rebuild_for(cfg))
    with pytest.raises(torch.OutOfMemoryError):
        dispatch("step", 0)
    assert escalate(cfg) is None


@pytest.mark.parametrize("error", [
    ValueError("shape mismatch"),
    RuntimeError("CUDA out of memory (a message alone is not an OOM)"),
    MemoryError("host allocation")])
def test_non_oom_errors_propagate(error):
    cfg = Config()

    def rebuild():
        def step(x):
            raise error
        return {"step": step}

    dispatch = oom_dispatch(cfg, 0, rebuild)
    with pytest.raises(type(error)):
        dispatch("step", 0)
    assert not (cfg.remat or cfg.gp_chunked or cfg.remat_blocks)


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA out of memory"), False),
    (RuntimeError("RESOURCE_EXHAUSTED: Ran out of memory in hbm"), False),
    (MemoryError(), False)])
def test_only_torch_out_of_memory_is_an_oom(exc, want):
    assert is_oom(exc) is want


def test_kwargs_pass_through():
    cfg = Config()

    def rebuild():
        return {"sample": lambda x, mode="rand": (x, mode)}

    dispatch = oom_dispatch(cfg, 0, rebuild)
    assert dispatch("sample", 1, mode="rec") == (1, "rec")


# ---------------------------------------------------------------------------
# rollback of a real step
# ---------------------------------------------------------------------------

def _models(**over):
    cfg = fast.cfg_of(Config, **over)
    cfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    return cfg, G, D, pyr


def _two_steps(cfg, G, D, pyr, inject=None):
    """Two GAN steps from fixed inputs and draws (the second from the
    first's optimizer states), each through a ``Ladder``; ``inject(D,
    opt_d)`` arms the second step's OOM."""
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    ladder = Ladder(cfg, SCALE, (G, D), (opt_g, opt_d))
    for i in range(2):
        real, real_zero, noise_init = fast.data(pyr, 3, SCALE, 5 + i)
        draws = steps.gan_draws(G, torch.as_tensor(noise_init),
                                real_zero.shape,
                                generator=torch.Generator().manual_seed(i))
        if i == 1 and inject is not None:
            inject(D, opt_d)
        ladder(steps.gan_step, G, D, opt_g, opt_d, cfg, real, real_zero,
               noise_init, fast.AMPS, noises=draws["noises"],
               eps=draws["eps"], alpha=draws["alpha"])
    return (opt_g, opt_d), ladder


def _assert_same_state(mods, opts, ref_mods, ref_opts):
    for m, r in zip(mods, ref_mods):
        want = r.state_dict()
        for name, t in m.state_dict().items():
            assert torch.equal(t, want[name]), name
    for o, r in zip(opts, ref_opts):
        for a, b in zip(o.param_groups, r.param_groups):
            for p, q in zip(a["params"], b["params"]):
                for k, v in r.state[q].items():
                    assert torch.equal(o.state[p][k], v), k


class _Once:
    """Raises an OOM at the ``at``-th call of ``fn`` (1-based), once;
    ``after``: let that call run first, then raise."""

    def __init__(self, fn, at=1, after=False):
        self.fn, self.at, self.after, self.calls = fn, at, after, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == self.at and not self.after:
            raise _oom()
        out = self.fn(*args, **kwargs)
        if self.calls == self.at:
            raise _oom()
        return out


@pytest.mark.parametrize("where", ["critic_forward", "gradient_penalty",
                                   "after_critic_adam"])
def test_a_retried_step_equals_the_rung_from_the_start(where, monkeypatch,
                                                       caplog):
    """The OOM hits the second step: after the spectral updates and the
    critic's fake forward (critic_forward), inside the double backward's
    forward (gradient_penalty), or once the critic's Adam update is
    applied (after_critic_adam).  The rollback restores the parameters,
    both optimizers' states, the BatchNorm and spectral buffers, and the
    retry runs under --remat."""
    cfg_r, G_r, D_r, pyr = _models(remat=True)
    ref_opts, _ = _two_steps(cfg_r, G_r, D_r, pyr)

    def inject(D, opt_d):
        if where == "critic_forward":
            monkeypatch.setattr(D, "_forward", _Once(D._forward))
        elif where == "gradient_penalty":
            monkeypatch.setattr(losses, "_penalty", _Once(losses._penalty))
        else:
            monkeypatch.setattr(opt_d, "step", _Once(opt_d.step, after=True))

    cfg, G, D, pyr = _models()
    with caplog.at_level(logging.WARNING):
        opts, ladder = _two_steps(cfg, G, D, pyr, inject)
    assert ladder.escalations == ["rematerialization (--remat)"]
    assert cfg.remat and not cfg.gp_chunked
    assert "enabling rematerialization (--remat)" in caplog.text
    _assert_same_state((G, D), opts, (G_r, D_r), ref_opts)


def _batches(pyr, scale, seed):
    rng = np.random.default_rng(seed)
    while True:
        yield (np.tanh(rng.standard_normal(
            (fast.BATCH, *pyr.shape3d(scale), 3))).astype(np.float32),
               np.tanh(rng.standard_normal(
                   (fast.BATCH, *pyr.shape3d(0), 3))).astype(np.float32))


def _train(monkeypatch=None, where=None, **over):
    cfg, G, D_prev, pyr = _models(niter=3, **over)
    cfg.Noise_Amps = [1.0, 0.3, 0.2]
    if where == "step":
        monkeypatch.setattr(trainer, "gan_step",
                            _Once(steps.gan_step, at=2, after=True))
    elif where == "calibration":
        monkeypatch.setattr(trainer, "calibrate", _Once(steps.calibrate))
    G, D, history = trainer.train_scale(cfg, G, _batches(pyr, SCALE, 3),
                                        D_prev=D_prev, seed=5)
    return cfg, G, D, history


@pytest.mark.parametrize("where,scan", [("step", 1), ("step", 2),
                                        ("calibration", 1)])
def test_train_scale_escalates_and_ends_as_the_rung_from_the_start(
        monkeypatch, where, scan):
    """An OOM at iteration 1 (after that step ran whole: the rollback
    undoes it) or in the iteration-0 calibration: ``train_scale`` turns
    on --remat, keeps it on ``cfg``, and ends with the weights, buffers
    and amp of a run under --remat from the start."""
    cfg_r, G_r, D_r, hist_r = _train(remat=True, scan_steps=scan)
    cfg, G, D, hist = _train(monkeypatch, where, scan_steps=scan)
    assert cfg.remat and not cfg.gp_chunked and not cfg.remat_blocks
    assert len(hist) == 3
    assert cfg.Noise_Amps == cfg_r.Noise_Amps
    _assert_same_state((G, D), (), (G_r, D_r), ())
    for got, want in zip(hist, hist_r):
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_the_baselines_trainer_retries_with_the_same_draws(monkeypatch):
    """``train_scale_baselines`` makes the iteration's generator afresh
    for the retry: the escalated step (the BatchNorm critic, where
    --gp-chunked is a no-op) draws what the rung-from-the-start step
    draws."""
    from hpvaegan_tpu_torch.train import trainer_baselines as tb

    def run(**over):
        cfg = fast.cfg_of(Config, generator="GeneratorCSG",
                          discriminator="WDiscriminatorBaselines", niter=2,
                          **over)
        cfg.scale_idx, cfg.resumed_idx, cfg.Noise_Amps = 1, -1, [1.0, 0.4]
        cfg.td = cfg.pyramid().td(0)
        pyr = cfg.pyramid()
        G = make_generator("GeneratorCSG", cfg, pyr, ndim=3)
        G.init(torch.Generator().manual_seed(0)).init_next_stage()
        G.requires_grad_(True)
        saved = {}

        class Saver:
            experiment_dir = ""

            def save_checkpoint(self, state, name, blocking=False):
                saved[name] = state

            def save_json(self, *a):
                pass

            def wait(self):
                pass

        batches = _batches(pyr, 1, 8)
        monkeypatch.setattr(tb, "make_loader",
                            lambda *a, **k: _Loader(batches))
        monkeypatch.setattr(tb, "_warm_start", lambda *a: None)
        G, D = tb.train_scale_baselines(cfg, G, None, Saver(), seed=3)
        return cfg, G, D

    _, G_r, D_r = run(remat=True, gp_chunked=True)
    monkeypatch.setattr(tb, "baseline_step",
                        _Once(steps.baseline_step, at=2, after=True))
    cfg, G, D = run(remat=True)
    assert cfg.gp_chunked and not cfg.remat_blocks
    _assert_same_state((G, D), (), (G_r, D_r), ())


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __next__(self):
        return next(self.batches)

    def close(self):
        pass


def test_a_multi_rank_ladder_needs_a_process_group():
    """Without a process group the ladder is a single process's: no
    agreement group is made."""
    Ladder(Config(), 0, (), mesh=object())
    assert fallback._agree_group is None
