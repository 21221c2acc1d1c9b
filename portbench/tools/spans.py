#!/usr/bin/env python3
"""A cell's traced window read by the measured package's own spans, on the
card, in one process a run:

    python3 portbench/tools/spans.py --workload hpvaegan3d.train_s9 \\
        --seeds 11 12

Each seed runs the cell as ``run.py --trace 1`` does (the same set-up,
traced window and comparison), whose ``TraceSummary`` holds the window's
spans.  For each run it prints the span table of
``harness/program_spans.py`` on standard error (count, device ms,
launches, self host ms and idle ms a span name) and one JSON line on
standard output: the run's result line's ``correct``, per-layer metrics,
``busy_s``, ``window_s`` and ``units``, ``window_s / units``, and the span
readers' values: ``critic_ms``, ``generator_ms`` and ``spectral_ms`` (a
step's device ms launched inside ``step.critic``, ``step.generator``,
``step.spectral``), ``host_tail_ms`` and ``launch_idle_ms`` (a request's,
median), each None where the window holds nothing to read.  The
per-layer metrics ``critic_ms.train``, ``generator_ms.train``,
``host_tail_ms.sample`` and ``launch_idle_ms.sample`` read the same."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from harness import program_spans  # noqa: E402
from harness.cells import load_cell  # noqa: E402
from harness.common import note  # noqa: E402
from harness.runner import run_cell  # noqa: E402


def _read(spans: program_spans.ProgramSpans):
    """The span readers' values and the span table of a window."""
    return {
        "critic_ms": program_spans.per_span_ms(spans, "step.critic"),
        "generator_ms": program_spans.per_span_ms(spans, "step.generator"),
        "spectral_ms": program_spans.per_span_ms(spans, "step.spectral"),
        "host_tail_ms": program_spans.host_tail_ms(spans),
        "launch_idle_ms": program_spans.launch_idle_ms(spans),
    }, program_spans.table(spans)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 1
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        result, run = run_cell(cell, seed, args.seconds, True, dev,
                               t0=time.perf_counter())
        values, lines = _read(run.trace.spans)
        for line in lines:
            note(line)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"],
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "busy_s": run.trace.busy_s, "window_s": run.trace.window_s,
            "units": run.units, "window_per_unit_s":
                run.trace.window_s / run.units,
            "spans": values}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
