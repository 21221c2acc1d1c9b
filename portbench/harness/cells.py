"""A cell of ``BENCHMARK.json``, resolved from its files by name:

* the configuration: the ``file`` its ``configs`` entry names;
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* the limits of its correctness numbers: ``portbench/limits/<cell>.json``;
* each per-layer metric's reader: ``portbench/metrics/<metric>.py``, a
  module with ``read(reading) -> float | None``;
* the model family of the configuration's ``generator``:
  ``portbench/families/<generator>.py`` (its contract:
  ``portbench/README.md``).

Adding a cell, a configuration, a traffic mix, a metric or a model adds
files and entries; no code here names one."""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FAMILIES = BENCH / "families"

__all__ = ["ROOT", "BENCH", "FAMILIES", "Cell", "load_cell", "reader",
           "family", "benchmark"]


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict            # the configuration file
    traffic_name: str
    traffic: dict           # the traffic file
    chips: int
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # ... and with --trace 1
    limits: Dict[str, float]
    family: ModuleType      # families/<the configuration's generator>.py


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict = None) -> Cell:
    spec = benchmark() if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name) and m["moves"] in moved]
    config = _json(ROOT / conf["file"])
    return Cell(name=name, config_name=w["config"], config=config,
                traffic_name=w["traffic"],
                traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=_json(BENCH / "limits" / f"{name}.json"),
                family=family(config["generator"]))


def _load(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``."""
    return _load(BENCH / "metrics" / f"{metric}.py", "portbench_metric").read


def family(generator: str) -> ModuleType:
    """The model family ``FAMILIES / <generator>.py``, loaded once a path;
    a generator without one is refused, naming the file to add."""
    path = FAMILIES / f"{generator}.py"
    if not path.is_file():
        shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        raise FileNotFoundError(
            f"no model family for the generator {generator!r}: add {shown} "
            f"(its contract: portbench/README.md)")
    return _family(path)


@functools.lru_cache(maxsize=None)
def _family(path: Path) -> ModuleType:
    return _load(path, "portbench_family")
