"""One run of a cell: drive it, read its metrics, compare its outputs,
and make the result line's object."""
from __future__ import annotations

import math
import sys
import time

import torch

from . import sample_cell, train_cell
from .cells import reader
from .common import Run, note
from .yardstick import peak_flops

__all__ = ["run_cell", "forbidden_modules", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hpvaegan_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is a forbidden one, whole:
    ``hpvaegan_tpu_torch`` is not ``hpvaegan_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             conf: dict = None, t0: float = None):
    """Drive ``cell`` once; returns ``(result, run)``, the result line's
    object and the run's record."""
    kind = cell.traffic["kind"]
    runner = {"train": train_cell, "sample": sample_cell}[kind]
    run = Run(kind=kind, t0=time.perf_counter() if t0 is None else t0,
              peak_flops=peak_flops(bool((conf or cell.config)["bf16"])))
    gaps = (runner.run_train if kind == "train" else runner.run_sample)(
        cell, seed, seconds, trace, dev, run, conf)
    run.checks = {name: float(v) for name, v in gaps.items()}
    # a null limit: a number with no upper reading, left uncompared
    # (PERF.md section 2); the run must still give it
    compared = sorted(n for n in gaps if cell.limits.get(n) is not None)
    checks = {name: {"value": run.checks[name],
                     "limit": float(cell.limits[name])}
              for name in compared}
    for name in sorted(set(gaps) - set(compared)):
        note(f"not compared (its limit is null): {name} "
             f"{run.checks[name]!r}")
    correct = (run.failed == 0 and set(gaps) == set(cell.limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        # a run whose window closed at set-up's end (the readings) has
        # no window metrics
        values = dict(runner.window_metrics(run) if run.units else {},
                      setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.units),
              "failed": int(run.failed), "metrics": metrics,
              "device": device}
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result, run
