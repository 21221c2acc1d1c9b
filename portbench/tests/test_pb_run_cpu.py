"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line's keys, the program against the
plain reference, and each fault a cell can have, planted under the timed
path, reading ``correct`` false against the cell's own limits."""
import torch
import pytest

from harness.cells import benchmark, load_cell
from harness.runner import run_cell
from harness.train_cell import first_steps
from hpvaegan_tpu_torch.serving import SamplerSession

_APPLY = SamplerSession._apply

SPEC = benchmark()
KINDS = {w["name"]: load_cell(w["name"], SPEC).traffic["kind"]
         for w in SPEC["workloads"]}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # wider than 32 signed bits, as the driver's
# a pyramid of four levels; the cell trains its top (scale 3, the critic
# warm-started from the previous GAN scale's: vae_levels 2)
TINY = dict(img_size=24, min_size=12, max_size=24, vae_levels=2)
# f32 on the CPU at these sizes: the program's plain kernel versions sum
# in another order than the reference's convolutions, and Adam's first
# steps turn round-off in near-zero gradients into whole steps, so the
# losses of the later steps and the leaves' changes drift by up to about
# 1e-3 and 2e-2 of their size (measured 1.1e-3 and 1.4e-2); the first
# gradient and the clips agree to round-off
TOL = {"loss_gap": 1e-2, "grad_gap": 1e-3, "change_gap": 5e-2,
       "window_loss_gap": 1e-2, "window_change_gap": 5e-2, "clip_gap": 1e-4}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _tiny(name):
    cell = load_cell(name, SPEC)
    cell.traffic = dict(cell.traffic, scale=3, compare_below=4,
                        compare_requests=2, warmup_requests=1)
    return cell, dict(cell.config, **TINY)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sound_run(name):
    cell, conf = _tiny(name)
    result, run = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for key, check in result["checks"].items():
        assert check["value"] <= TOL[key], (key, check)


@pytest.mark.parametrize("name", sorted(n for n, k in KINDS.items()
                                        if k == "train"))
def test_window_closes_at_setup_end(name):
    """``--seconds 0``: the set-up's steps, all of their losses compared,
    and no window (so no window numbers)."""
    cell, conf = _tiny(name)
    result, run = run_cell(cell, SEED, 0, False, CPU, conf=conf)
    assert result["attempted"] == 0 and run.window_s == 0
    assert set(result["metrics"]) == {"setup_s"}
    for key, check in result["checks"].items():
        assert check["value"] <= TOL[key], (key, check)


def _planted(monkeypatch, faulty, after: int) -> None:
    """The trainer's GAN step replaced by ``faulty(step, *args)`` from its
    ``after``-th call on (0: every step; set-up's first steps: the
    window's steps alone)."""
    from hpvaegan_tpu_torch.train import trainer
    step, calls = trainer.gan_step, [0]

    def gan_step(*args, **kwargs):
        calls[0] += 1
        if calls[0] > after:
            return faulty(step, *args, **kwargs)
        return step(*args, **kwargs)
    monkeypatch.setattr(trainer, "gan_step", gan_step)


def _unchanged(step, G, D, *args, **kwargs):
    kept = [(t, t.detach().clone())
            for t in list(G.parameters()) + list(D.parameters())]
    out = step(G, D, *args, **kwargs)
    with torch.no_grad():
        for t, v in kept:
            t.copy_(v)
    return out


def _half_batch(step, G, D, opt_g, opt_d, cfg, real, real_zero, noise_init,
                amps, noises=None, eps=None, **kwargs):
    return step(G, D, opt_g, opt_d, cfg, real[:1], real_zero[:1],
                noise_init[:1], amps,
                noises=[None if n is None else n[:1] for n in noises],
                eps=eps[:1], **kwargs)


def _altered(self, **kw):
    out = _APPLY(self, **kw).clone()
    out.view(-1)[0] += 0.5
    return out


def _train_fault(faulty, late: bool):
    def plant(monkeypatch, cell):
        _planted(monkeypatch, faulty, first_steps(cell.traffic) if late
                 else 0)
    return plant


FAULTS = {"train": {"unchanged": _train_fault(_unchanged, False),
                    "half_batch": _train_fault(_half_batch, False),
                    "window_unchanged": _train_fault(_unchanged, True),
                    "window_half_batch": _train_fault(_half_batch, True)},
          "sample": {"altered": lambda monkeypatch, cell:
                     monkeypatch.setattr(SamplerSession, "_apply",
                                         _altered)}}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in sorted(KINDS) for f in sorted(FAULTS[KINDS[n]])])
def test_fault_reads_incorrect(name, fault, monkeypatch):
    """Each fault, planted in every step or (``window_``) in the window's
    steps alone, after set-up's first steps, reads ``correct`` false."""
    cell, conf = _tiny(name)
    FAULTS[KINDS[name]][fault](monkeypatch, cell)
    result, _ = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
