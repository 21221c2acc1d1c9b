"""The model family: every configuration of BENCHMARK.json finds its own
by its ``generator``, a generator without one is refused naming the file
to add, a family is found by its file alone (a copy elsewhere runs the
tiny cells ``correct``), a stand-in family whose trainer calls its step
through another attribute has its faults planted there, no module outside
a family imports the reference's model or steps or names a model's step,
and MFU reads against the compute dtype's peak."""
import ast
import json
import re
import shutil
import sys
import types

import pytest
import torch

from harness import cells
from harness.cells import BENCH, benchmark, family, load_cell, reader
from harness.runner import run_cell
from harness.yardstick import PEAK_BF16_FLOPS, PEAK_F32_FLOPS

SPEC = benchmark()
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
# the contract of families/<generator>.py (portbench/README.md)
CONTRACT = ("LOSS_TERMS", "models", "draw", "port_generator", "amps_before",
            "train", "STEP", "half_batch_call", "loss_gaps", "follow",
            "resume", "model_state", "request_draws", "reference_clip",
            "flop_step", "flop_request")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _tiny(name, **conf):
    from test_pb_run_cpu import TINY
    cell = load_cell(name, SPEC)
    cell.traffic = dict(cell.traffic, scale=3, compare_below=4,
                        compare_requests=2, warmup_requests=1)
    return cell, dict(cell.config, **TINY, **conf)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_each_configuration_finds_its_family(conf):
    cell = next(load_cell(w["name"], SPEC) for w in SPEC["workloads"]
                if w["config"] == conf["name"])
    fam = family(cell.config["generator"])
    assert cell.family is fam
    assert fam.__file__ == str(BENCH / "families"
                               / f"{cell.config['generator']}.py")
    assert all(hasattr(fam, name) for name in CONTRACT)


def test_a_generator_without_a_family_is_refused(tmp_path):
    conf = dict(load_cell(SPEC["workloads"][0]["name"], SPEC).config,
                generator="GeneratorCSG_missing")
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    spec = dict(SPEC, configs=[dict(c, file=str(path))
                               for c in SPEC["configs"]])
    with pytest.raises(FileNotFoundError,
                       match="portbench/families/GeneratorCSG_missing.py"):
        load_cell(SPEC["workloads"][0]["name"], spec)


@pytest.mark.parametrize("kind", ["train", "sample"])
def test_a_family_is_found_by_its_file_alone(kind, tmp_path, monkeypatch):
    """The families directory pointed at a copy: the tiny cell of each
    kind runs ``correct`` on the copy, and no module was imported from
    the original."""
    from test_pb_run_cpu import bar
    name = next(w["name"] for w in SPEC["workloads"]
                if load_cell(w["name"], SPEC).traffic["kind"] == kind)
    generator = load_cell(name, SPEC).config["generator"]
    original = BENCH / "families" / f"{generator}.py"
    shutil.copy(original, tmp_path / original.name)
    monkeypatch.setattr(cells, "FAMILIES", tmp_path)
    cell, conf = _tiny(name)
    assert cell.family.__file__ == str(tmp_path / original.name)
    result, _ = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert result["correct"], result["checks"]
    for key, check in result["checks"].items():
        assert check["value"] <= bar(conf)[key], (key, check)
    assert not [m for m in list(sys.modules.values())
                if getattr(m, "__file__", None) == str(original)]


# appended to a copy of families/GeneratorHPVAEGAN.py: the same network
# under another generator's name, whose trainer calls the GAN step
# through ``steps.gan_step``, looked up at each call, so that a fault
# planted in ``trainer.gan_step`` before the scale would not reach it
STAND_IN = """
STEP = ("hpvaegan_tpu_torch.train.steps", "gan_step")
_port_generator = port_generator


def port_generator(cfg, *args):
    cfg.generator = "GeneratorHPVAEGAN"
    return _port_generator(cfg, *args)


def train(cfg, G, D_ref, batches, dataset, workdir, seed, callback):
    from hpvaegan_tpu_torch.train import steps, trainer

    def step(*args, **kwargs):
        return steps.gan_step(*args, **kwargs)
    saved, trainer.gan_step = trainer.gan_step, step
    try:
        trainer.train_scale(cfg, G, batches, D_prev=D_ref, seed=seed,
                            callback=callback)
    finally:
        trainer.gan_step = saved
"""


@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged",
                                   "window_half_batch", "window_unchanged"])
def test_a_stand_in_familys_faults_read_incorrect(fault, tmp_path,
                                                  monkeypatch):
    """The tiny scale-9 cell on a configuration of ``GeneratorStandIn``:
    sound, ``correct``; each fault, planted through the stand-in's own
    ``STEP``, ``correct`` false against the cell's limits."""
    from test_pb_run_cpu import FAULTS, TINY
    original = BENCH / "families" / "GeneratorHPVAEGAN.py"
    (tmp_path / "GeneratorStandIn.py").write_text(original.read_text()
                                                  + STAND_IN)
    name = "hpvaegan3d.train_s9"
    conf = dict(load_cell(name, SPEC).config, generator="GeneratorStandIn")
    monkeypatch.setattr(cells, "FAMILIES", tmp_path)
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    spec = dict(SPEC, configs=[dict(c, file=str(path)) for c in
                               SPEC["configs"]])
    cell = load_cell(name, spec)
    assert cell.family.STEP[0] == "hpvaegan_tpu_torch.train.steps"
    cell.traffic = dict(cell.traffic, scale=3)
    conf = dict(cell.config, **TINY)
    if fault is not None:
        FAULTS["train"][fault](monkeypatch, cell)
    result, _ = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert result["correct"] is (fault is None), result["checks"]


_STEPS = re.compile(r"\b(gan_step|baseline_step)\b")


@pytest.mark.parametrize("path", sorted((BENCH / "harness").glob("*.py"))
                         + [BENCH / "tests" / "test_pb_run_cpu.py"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_step_is_named_outside_a_family(path):
    """The harness and the CPU cell tests reach a model's step through its
    family's ``STEP`` alone."""
    assert not _STEPS.findall(path.read_text()), path


def _imports(path):
    """(module, names) of each import in ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, ()
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, tuple(a.name for a in node.names)


OUTSIDE = sorted(p for p in BENCH.rglob("*.py")
                 if p.relative_to(BENCH).parts[0] not in
                 ("families", "reference", "tests"))


@pytest.mark.parametrize("path", OUTSIDE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_only_a_family_imports_the_reference_model(path):
    for module, names in _imports(path):
        assert module != "reference.model", path
        if module == "reference.train":
            assert names == ("seed_value",), (path, names)
        assert module not in ("reference", "families"), (path, module)


@pytest.mark.parametrize("bf16,peak", [(False, PEAK_F32_FLOPS),
                                       (True, PEAK_BF16_FLOPS)])
def test_mfu_reads_against_the_compute_dtypes_peak(bf16, peak):
    """A run of the configuration in its dtype records that dtype's peak
    (set-up's steps alone), and the MFU readers divide by it."""
    name = next(w["name"] for w in SPEC["workloads"]
                if load_cell(w["name"], SPEC).traffic["kind"] == "train")
    cell, conf = _tiny(name, bf16=bf16)
    _, run = run_cell(cell, SEED, 0, False, CPU, conf=conf)
    assert run.peak_flops == peak
    run.trace = types.SimpleNamespace(window_s=2.0)
    run.units, run.flops_per_unit = 3, 10 ** 12
    assert reader("mfu.train")(run) == pytest.approx(
        100.0 * 3e12 / 2.0 / peak)
    run.kind = "sample"
    assert reader("mfu.sample")(run) == pytest.approx(
        100.0 * 3e12 / 2.0 / peak)


def test_a_null_limit_leaves_its_number_uncompared():
    """A number whose limit is null (no upper reading) is given by the run
    and kept on the run's record, but neither decides ``correct`` nor
    appears among the result line's checks; a number with no entry at
    all fails the run."""
    name = next(w["name"] for w in SPEC["workloads"]
                if load_cell(w["name"], SPEC).traffic["kind"] == "train")
    cell, conf = _tiny(name)
    cell.limits = {"loss_gap": None, "grad_gap": 1.0, "change_gap": 1.0,
                   "window_loss_gap": 1.0, "window_change_gap": 1.0}
    result, run = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert result["correct"] and set(result["checks"]) == {
        "grad_gap", "change_gap", "window_loss_gap", "window_change_gap"}
    assert set(run.checks) == set(cell.limits)
    del cell.limits["loss_gap"]
    result, _ = run_cell(cell, SEED, 0.5, False, CPU, conf=conf)
    assert result["correct"] is False
