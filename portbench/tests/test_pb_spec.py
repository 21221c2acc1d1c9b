"""Every cell of BENCHMARK.json resolves from its files by name, and the
file keeps to the benchmark contract's shapes."""
import json
import os
import re

import pytest

from harness.cells import BENCH, ROOT, benchmark, load_cell, reader

SPEC = benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = load_cell(name, SPEC)
    assert cell.traffic["kind"] in ("train", "sample")
    assert int(cell.traffic["scale"]) >= 0
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    wanted = ({"loss_gap", "grad_gap", "change_gap", "window_loss_gap",
               "window_change_gap"}
              if cell.traffic["kind"] == "train" else {"clip_gap"})
    assert set(cell.limits) == wanted
    for m in cell.per_layer:
        assert callable(reader(m["name"]))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    with open(ROOT / conf["file"]) as f:
        data = json.load(f)
    assert conf["file"].startswith("portbench/")
    for key in conf["reduced"]:
        assert key in data
    src = data.get("video_path") or data["image_path"]
    assert os.path.isfile(ROOT / (src.rsplit(".", 1)[0] + ".frames.npz"))


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        layers.setdefault(m["layer"], m["layer"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(BENCH / "traffic" / f"{w['traffic']}.json")
    assert len(json.dumps(SPEC)) < 64 * 1024
