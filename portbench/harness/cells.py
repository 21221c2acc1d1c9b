"""A cell of ``BENCHMARK.json``, resolved from its files by name:

* the configuration: the ``file`` its ``configs`` entry names;
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* the limits of its correctness numbers: ``portbench/limits/<cell>.json``;
* each per-layer metric's reader: ``portbench/metrics/<metric>.py``, a
  module with ``read(reading) -> float | None``.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no code here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"

__all__ = ["ROOT", "BENCH", "Cell", "load_cell", "reader", "benchmark"]


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
    return Cell(name=name, config_name=w["config"],
                config=_json(ROOT / conf["file"]),
                traffic_name=w["traffic"],
                traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits=_json(BENCH / "limits" / f"{name}.json"))


def reader(metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
