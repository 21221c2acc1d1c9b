"""Time variants of a kernel's source against each other on the card.

    python -m hpvaegan_tpu_torch.tools.kernel_variants k2-parts [...]

Each variant is the source in ``csrc/`` with some text replaced, built by
nvcc with the package's flags into ``build/kernels/variants/``, loaded
with ctypes and called directly at the critic's shape (4,13,144,256,64):
all variants in one process, in turns, two rounds, CUDA events around 5
(K2) or 20 (K1-dw) launches after 2 warm-up ones.  Each line gives the
round, the variant, its max |result - plain version| on a small ragged
shape and its ms.  Variants marked "(wrong)" cut work out to see what a
part of the kernel costs; their results are not meant to agree.

Experiments:

* ``k2-unroll``: K2 f32's channel loop fully unrolled (the source), by 8,
  4 or 2;
* ``k2-parts``: K2 f32 with conv1's or conv2's FMA loop, the x slab
  staging, or the per-stage barriers cut out (wrong);
* ``k2-loads``: K2 f32 with each thread's weight or activation loads made
  one broadcast address (wrong): is shared memory the limit?
* ``dw-ring``: K1-dw bf16 with 4, 5 (the source) or 6 ring stages.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from ..ops.kernels import _build
from ..ops.kernels import conv3d_fuse as cf
from ..ops.kernels import conv3d_pack as cp

__all__ = ["EXPERIMENTS", "variant_sources"]

Edit = Tuple[str, str]

_K2_C1 = ("      if (conv1_on)\n        stage_fma<PX1, CO1, F_XSTRIDE>(",
          "      if (conv1_on && T < 0)\n        stage_fma<PX1, CO1, F_XSTRIDE>(")
_K2_C2 = ("      stage_fma<PX2, CO2, F_ZSTRIDE>(",
          "      if (T < 0) stage_fma<PX2, CO2, F_ZSTRIDE>(")
_K2_LOOP = "#pragma unroll\n  for (int ci = 0; ci < F_QCI; ++ci) {"
_DW_RING = "constexpr int BW_STAGES = 5;"

# experiment -> (source name, {variant: edits})
EXPERIMENTS: Dict[str, Tuple[str, Dict[str, List[Edit]]]] = {
    "k2-unroll": ("conv3d_fuse", {
        "full": [],
        **{f"by {n}": [(_K2_LOOP, _K2_LOOP.replace(
            "#pragma unroll", f"#pragma unroll {n}"))] for n in (8, 4, 2)},
    }),
    "k2-parts": ("conv3d_fuse", {
        "full": [],
        "no conv1 FMA (wrong)": [_K2_C1],
        "no conv2 FMA (wrong)": [_K2_C2],
        "no FMA (wrong)": [_K2_C1, _K2_C2],
        "no x staging (wrong)": [(
            "        stage_x(x, g, slice, xs);",
            "        if (T < 0) stage_x(x, g, slice, xs);")],
        "barriers only at layers and x slices (wrong)": [(
            "    bf16_mma::cp_async_wait<0>();\n    __syncthreads();",
            "    bf16_mma::cp_async_wait<0>();\n"
            "    if (cur.first_of_layer() || (cur.dh == 0 && cur.q == 0))"
            " __syncthreads();")],
    }),
    "k2-loads": ("conv3d_fuse", {
        "full": [],
        "conv1 weights broadcast (wrong)": [("wst, cg1,", "wst, 0,")],
        "conv2 weights broadcast (wrong)": [("wst, cg2,", "wst, 0,")],
        "conv1 x broadcast (wrong)": [(
            "xs + cur.q * F_QCI * F_XSTRIDE + (r1 + cur.dh) * F_XW + c1,",
            "xs + cur.q * F_QCI * F_XSTRIDE,")],
        "conv2 z broadcast (wrong)": [(
            "zslot + cur.q * F_QCI * F_ZSTRIDE + (r2 + cur.dh) * F_ZW + c2,",
            "zslot + cur.q * F_QCI * F_ZSTRIDE,")],
    }),
    "dw-ring": ("conv3d_dw", {
        f"{n} stages": ([] if n == 5 else
                        [(_DW_RING, _DW_RING.replace("5", str(n)))])
        for n in (4, 5, 6)}),
}

SHAPE = (4, 13, 144, 256, 64)        # the critic's
CHECK_SHAPE = (1, 2, 9, 130, 64)     # ragged in every tile of both kernels


def variant_sources(experiment: str) -> Tuple[str, Dict[str, str]]:
    """(source name, {variant: source text}); raises if an edit does not
    match the source exactly once."""
    name, variants = EXPERIMENTS[experiment]
    base = (_build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for variant, edits in variants.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{experiment}/{variant}: the edit does not "
                                 f"match {name}.cu exactly once: {old!r}")
            text = text.replace(old, new)
        out[variant] = text
    return name, out


def _build_variants(experiment: str) -> Dict[str, ctypes.CDLL]:
    name, sources = variant_sources(experiment)
    out_dir = _build.BUILD_DIR / "variants" / experiment
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, text) in enumerate(sources.items()):
        src = out_dir / f"{name}_{i}.cu"
        src.write_text(text)
        procs[variant] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out_dir / f"{name}_{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out_dir / f"{name}_{i}.so")
    libs = {}
    try:
        for variant, (proc, lib) in procs.items():
            log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {experiment}/{variant}:\n{log}")
            libs[variant] = ctypes.CDLL(str(lib))
    finally:  # stop the builds still running when one failed
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return libs


def _k2_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    scale = (27 * 64) ** -0.5
    x = torch.randn(shape, device=dev, generator=g)
    w1, w2 = ((torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2
               - 1) * scale for _ in range(2))
    b1, b2 = ((torch.rand(64, device=dev, generator=g) * 2 - 1) * scale
              for _ in range(2))
    y = torch.empty_like(x)

    def run():
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), y.data_ptr(), None, *shape[:4], cf.SLOPE,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return y
    return run, lambda: cf.conv3d64_pair_plain(x, w1, b1, w2, b2)


def _dw_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_dw_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    x, dy = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
             for _ in range(2))
    cfg = cp.dw_kernel_config(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cp.dw_plan(sms, cfg["blocks_per_sm"], cfg["blocks_per_chunk"],
                      cfg["tile_w"], shape[:4])
    partial = torch.empty(plan.scratch_floats, device=dev)
    dw = torch.empty((3, 3, 3, 64, 64), device=dev)

    def run():
        err = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), *shape[:4], plan.nchunk,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return dw
    return run, lambda: cp.conv3d64_dw_plain(x, dy)


def run_experiment(experiment: str) -> None:
    dev = torch.device("cuda", 0)
    libs = _build_variants(experiment)
    make = _dw_runner if EXPERIMENTS[experiment][0] == "conv3d_dw" \
        else _k2_runner
    iters = 20 if make is _dw_runner else 5
    g = torch.Generator(device=dev).manual_seed(0)
    errs, runs = {}, {}
    for variant, lib in libs.items():
        run, plain = make(lib, CHECK_SHAPE, dev, g)
        errs[variant] = float((run() - plain()).abs().max())
        runs[variant] = make(lib, SHAPE, dev, g)[0]
    for rnd in range(2):
        for variant, run in runs.items():
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                run()
            e1.record()
            e1.synchronize()
            print(f"{experiment} round {rnd} {variant}: max_abs_err "
                  f"{errs[variant]:.3e}, {e0.elapsed_time(e1) / iters:.4f} "
                  f"ms at {SHAPE}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiments", nargs="+", choices=sorted(EXPERIMENTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for experiment in args.experiments:
        run_experiment(experiment)


if __name__ == "__main__":
    main()
