#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card,
in one process (set-up once a seed, a short window):

    python3 portbench/tools/readings.py --workload hpvaegan3d.train_s9 \\
        --seeds 11 12 13 --control-seeds 11 12 13

For each ``--seeds`` seed, the program's numbers: a run of the cell with
a window of ``--seconds`` (a training window as long as a run's, whose
last step or chunk the reference takes from the program's state: the
window numbers grow with the steps before it), then the comparison with
the reference, as a run makes it.  For each ``--control-seeds`` seed,
the control's: the reference put in the program's place and computed in
the nearest precision below the configuration's
(``harness.common.control_precision``: TF32 for f32 with TF32 off, fp8
convolution operands for bf16), compared with the f32 reference by the
same numbers, the window's segment taken from the f32 reference's own
state after the first steps; and, for a training cell, the fault of a
step that leaves half of its batch out (the reference on the first
sample alone, the mean over it).  A state left unchanged reads 1 on each
change gap by construction and needs no run.

Prints one JSON line a reading and a summary line last: each number's
largest program reading and smallest control and fault readings."""
from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from harness.cells import benchmark, load_cell  # noqa: E402
from harness.common import control_precision, precision  # noqa: E402
from harness.compare import train_gaps, window_gaps  # noqa: E402
from harness.models import reference_models  # noqa: E402
from harness.runner import run_cell  # noqa: E402
from harness.sample_cell import request_draws  # noqa: E402
from harness.train_cell import (first_steps, last_segment,  # noqa: E402
                                reference_batch, reference_pyramid)


def _shapes(conf, scale):
    pyr = reference_pyramid(conf)
    return pyr, [pyr.thw(i) if conf["ndim"] == 3 else pyr.hw(i)
                 for i in range(scale + 1)]


def train_controls(cell, seed: int, dev) -> dict:
    conf, tr, fam = cell.config, cell.traffic, cell.family
    scale, steps = int(tr["scale"]), first_steps(tr)
    pyr, shapes = _shapes(conf, scale)
    G, D = reference_models(fam, conf, conf["ndim"], shapes, scale, dev,
                            seed)
    real, real_zero = reference_batch(conf, pyr, scale, dev)
    amps = fam.amps_before(conf, scale)
    step_gaps = functools.partial(fam.loss_gaps, conf=conf)
    with precision(tf32=False):
        ref = fam.follow(G, D, conf, real, real_zero, amps, dev, seed,
                         scale, steps)
        half = fam.follow(G, D, conf, real, real_zero, amps, dev, seed,
                          scale, steps, fault="half_batch")
    with control_precision(bool(conf["bf16"])):
        low = fam.follow(G, D, conf, real, real_zero, amps, dev, seed,
                         scale, steps)
    out = {what: train_gaps(r["losses"], r["grads"], r["change"], ref,
                            step_gaps)
           for what, r in (("control", low), ("half_batch", half))}
    # the window's last segment from the state after the first steps
    seg = (G, D, conf, real, real_zero, amps + [ref["amp"]], dev, seed,
           scale, ref["state"], steps, last_segment(tr))
    with precision(tf32=False):
        want = fam.resume(*seg)
        half = fam.resume(*seg, fault="half_batch")
    with control_precision(bool(conf["bf16"])):
        low = fam.resume(*seg)
    for what, r in (("control", low), ("half_batch", half)):
        out[what].update(window_gaps(r["losses"], r["change"], want,
                                     ref["grads"], step_gaps))
    out["unchanged"] = {"change_gap": 1.0, "window_change_gap": 1.0}
    return out


def sample_controls(cell, seed: int, dev) -> dict:
    conf, tr, fam = cell.config, cell.traffic, cell.family
    scale = int(tr["scale"])
    _, shapes = _shapes(conf, scale)
    G, _ = reference_models(fam, conf, conf["ndim"], shapes, scale, dev,
                            seed)
    amps = fam.amps_before(conf, scale) + [conf["noise_amp"]]
    gap = 0.0
    for i in range(int(tr["compare_requests"])):
        z, noises = request_draws(fam, G, conf, dev, seed, i)
        outs = []
        for ctx in (precision(tf32=False),
                    control_precision(bool(conf["bf16"]))):
            with torch.no_grad(), ctx:
                outs.append(fam.reference_clip(G, amps, z, noises))
        gap = max(gap, float((outs[0] - outs[1]).abs().max()))
    return {"control": {"clip_gap": gap}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=None,
                        help="the program's window (default: "
                        "BENCHMARK.json's run_seconds for a training "
                        "cell, 0 for a sampling cell, whose window is "
                        "then its compared requests)")
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    seconds = args.seconds if args.seconds is not None else float(
        benchmark()["run_seconds"] if cell.traffic["kind"] == "train"
        else 0)
    lower, upper = {}, {}
    for seed in args.seeds:
        t = time.perf_counter()
        _, run = run_cell(cell, seed, seconds, False, dev)
        gaps = run.checks
        print(json.dumps({"seed": seed, "program": gaps,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in gaps.items():
            lower[k] = max(lower.get(k, 0.0), v)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        run = (train_controls if cell.traffic["kind"] == "train"
               else sample_controls)(cell, seed, dev)
        print(json.dumps({"seed": seed, **run,
                          "seconds": time.perf_counter() - t}), flush=True)
        for what, gaps in run.items():
            for k, v in gaps.items():
                key = f"{what}.{k}"
                upper[key] = min(upper.get(key, math.inf), v)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": lower,
                      "control_and_fault_min": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
