"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line's keys, the program against the
plain reference under the bar of the configuration's dtype, and each
fault a cell can have, planted under the timed path (a training fault in
the step that the model family's ``STEP`` names), reading ``correct``
false against the cell's own limits."""
import importlib

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
# bf16 (``bf16: true``) at these sizes against the f32 reference, over 44
# seeds (12 for the clips): Adam's first steps take the sign of each
# gradient component, and bf16 flips those of the near-zero ones, so after
# one step the critic's small scores part, and with them the generator's
# first gradient (taken through the updated critic), the later losses and
# the changes, by up to several tenths (worst loss 0.867: errG 3.52
# against 1.20 at step 2; medians 0.114 loss, 0.097 grad, 0.118 change,
# 0.041 and 0.085 window loss and change; worst grad, change, window loss
# and change 0.193, 0.252, 0.244, 0.367); the clips, through a bf16
# residual stream, 0.070 to 0.113
TOL_BF16 = {"loss_gap": 1.2, "grad_gap": 0.3, "change_gap": 0.4,
            "window_loss_gap": 0.4, "window_change_gap": 0.6,
            "clip_gap": 0.2}


def bar(conf: dict) -> dict:
    """The CPU bar of a configuration's sound runs, by its dtype."""
    return TOL_BF16 if conf["bf16"] else TOL


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# each cell as it is, and a bf16 copy of the first 3D training cell's
# configuration (``bf16: true``, no file edited), which is held to the
# bf16 bar
BF16 = "+bf16"
COPIED = next(n for n in sorted(KINDS) if KINDS[n] == "train"
              and load_cell(n, SPEC).config["ndim"] == 3) + BF16


def _tiny(name):
    cell = load_cell(name.removesuffix(BF16), SPEC)
    cell.traffic = dict(cell.traffic, scale=3, compare_below=4,
                        compare_requests=2, warmup_requests=1)
    return cell, dict(cell.config, **TINY, **(
        {"bf16": True} if name.endswith(BF16) else {}))


@pytest.mark.parametrize("name", sorted(KINDS) + [COPIED])
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
        assert check["value"] <= bar(conf)[key], (key, check)


@pytest.mark.parametrize("name", sorted(n for n, k in KINDS.items()
                                        if k == "train") + [COPIED])
def test_window_closes_at_setup_end(name):
    """``--seconds 0``: the set-up's steps, all of their losses compared,
    and no window (so no window numbers)."""
    cell, conf = _tiny(name)
    result, run = run_cell(cell, SEED, 0, False, CPU, conf=conf)
    assert result["attempted"] == 0 and run.window_s == 0
    assert set(result["metrics"]) == {"setup_s"}
    for key, check in result["checks"].items():
        assert check["value"] <= bar(conf)[key], (key, check)


def _planted(monkeypatch, family, faulty, after: int) -> None:
    """The step that ``family.STEP`` names replaced by ``faulty(step,
    *args)`` from its ``after``-th call on (0: every step; set-up's first
    steps: the window's steps alone)."""
    module, name = family.STEP
    owner = importlib.import_module(module)
    step, calls = getattr(owner, name), [0]

    def planted(*args, **kwargs):
        calls[0] += 1
        if calls[0] > after:
            return faulty(step, *args, **kwargs)
        return step(*args, **kwargs)
    monkeypatch.setattr(owner, name, planted)


def _unchanged(step, *args, **kwargs):
    """``step``, then every parameter of the modules it was handed (the
    generator's and the critic's) put back as it was."""
    modules = [a for a in (*args, *kwargs.values())
               if isinstance(a, torch.nn.Module)]
    kept = [(t, t.detach().clone()) for m in modules for t in m.parameters()]
    out = step(*args, **kwargs)
    with torch.no_grad():
        for t, v in kept:
            t.copy_(v)
    return out


def _altered(self, **kw):
    out = _APPLY(self, **kw).clone()
    out.view(-1)[0] += 0.5
    return out


def _train_fault(half_batch: bool, late: bool):
    def plant(monkeypatch, cell):
        faulty = cell.family.half_batch_call if half_batch else _unchanged
        _planted(monkeypatch, cell.family, faulty,
                 first_steps(cell.traffic) if late else 0)
    return plant


FAULTS = {"train": {"unchanged": _train_fault(False, False),
                    "half_batch": _train_fault(True, False),
                    "window_unchanged": _train_fault(False, True),
                    "window_half_batch": _train_fault(True, True)},
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
