#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 portbench/run.py --workload hpvaegan3d.train_s9 --seed 7 \\
        --seconds 30 --trace 0

It measures the PyTorch/CUDA package ``hpvaegan_tpu_torch`` on the card it
starts on, checks what the timed path produced against the plain
reference in ``portbench/reference/``, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and ``breakdown`` when traced), and last
``checks``, each compared number with its limit, which also close
standard error.  It exits non-zero with no result line when no card is
there, when the cell cannot be resolved, or when ``jax``, ``jaxlib``,
``flax``, ``optax`` or the JAX package ``hpvaegan_tpu`` is loaded once
the window has closed.

Kernel and compiler caches stay in fixed directories of the checkout:
the package's nvcc builds in ``build/kernels/``, Triton's in
``build/triton/``, PyTorch extensions' in ``build/torch_extensions/``."""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    for p in (ROOT, HERE):
        if p in sys.path:
            sys.path.remove(p)
    sys.path[:0] = [HERE, ROOT]


def _caches() -> None:
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _paths()
    _caches()
    import torch
    from harness.cells import load_cell
    from harness.common import note
    from harness.runner import forbidden_modules, run_cell
    cell = load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 1
    result, run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t0=T0)
    note(f"card: {_power_limit()}")
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the measured process: {found}",
              file=sys.stderr)
        return 1
    note("set-up parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
