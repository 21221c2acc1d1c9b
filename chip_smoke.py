#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hpvaegan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also torch.profiler tables of one
                                       # request and of the scale-9 steps

Phases; any failure exits non-zero and prints no result:

1. the card: name, power limit, device count;
2. the build: every kernel of the path compiled from ``csrc/`` with nvcc
   (one process per source, all started together), with ptxas's registers,
   shared memory and spills; the launch configuration of K1's forward,
   K1-dw and K2 in both dtypes (threads, shared memory, blocks an SM from
   the occupancy API, ptxas registers and spills), and of K3's three
   instances at the main path's channel counts;
3. each kernel against its plain PyTorch version at the main paths'
   shapes (f32, TF32 off), with its time, the plain version's time, the
   time of one library call computing the same function, and the bound:
   K1's forward, input gradient and weight gradient, and K2 (with and
   without its intermediate, and its backward; also at shapes on every
   edge of its tiling: W 1-256, H 1-144, T 1-13, B 1-3), timed against the
   unfused cuDNN pair (``unfused_ms`` in its row: no one call computes
   the pair);
3b. the same for the bf16 kernels (``--bf16``) at the top stage's shape
   (2,13,144,256,64) and the critic's (4,13,144,256,64), against cuDNN's
   bf16 conv, its bf16 gradients and the unfused bf16 pair, with the bound
   at the bf16 tensor-core rate; K1 (forward, dx, dw) and K2 also at the
   edge shapes of their tilings (dw's result equal from run to run), and
   K1's forward at each of the ten stage shapes at batch 2, timed through
   its wrapper (CUDA events) and alone (the profiler's device time)
   beside its bound;
3c. K3, the fused conv3d + bias + LeakyReLU for any channel count, one
   kernel with three instances (wide, narrow_in, narrow_out): each
   against its plain version at the top stage's shape (64 -> 64, 3 -> 64,
   64 -> 3), at a ragged 5 -> 7 shape with T = 1, 2, 4 and at ragged
   shapes across every instance's channel and tile boundaries, its
   gradients against autograd through the plain conv, each timed against
   cuDNN's conv + LeakyReLU.  The JAX package routes K3 nowhere, so its
   rows count the launches of this phase's own forward and backward at
   the three shapes (run before the comparisons): one per instance;
4. the serving path at full width: the repository's default 3D
   GeneratorHPVAEGAN (nfc 64, latent 128, 5 layers, 3 VAE levels, pyramid
   to 256 px) on the in-repo wingsuit clip's geometry (256x144, 24 fps),
   grown to scale 9 with random weights from ``--seed``, saved as a port
   checkpoint + config.json and served through ``SamplerSession`` on the
   card: three rand requests at batch 2 under ``--pconv-all``, each
   checked for shape, finite values in [-1, 1] and 45 K1 launches;
   before that, the same model widths on a small pyramid agree between the
   card and the CPU path on the same draws;
4b. the same with a checkpoint whose config.json says ``bf16``: each
   request 45 bf16 K1 launches, nothing else, bf16 values in [-1, 1];
5. the training path at full width, under ``--pconv --pconv-all --pfuse``
   with PyTorch's default TF32 flags (the steps hold f32 themselves):
   first one GAN step of the full-width model on a small pyramid on the
   card and on the CPU path from the same weights and draws (losses, BN
   statistics and spectral u/v agree); then ``train_scale`` at scale 2
   (2 VAE iterations) and at scale 9 (3 GAN iterations, the generator's
   top stage (2, 13, 144, 256), the critic on (4, 13, 144, 256, 3)) on
   clips made from ``--seed``, each step's wall time, losses, peak memory
   and launches per kernel printed and the launches checked;
5b. the same under ``--bf16``: per scale-9 GAN step 137 K1-fwd, 4 K2,
   80 K1-dx and 75 K1-dw launches of the bf16 kernels, no f32 launch and
   no plain call;
6. the training entry point at full width:
   ``python -m hpvaegan_tpu_torch.cli.train_video`` in-process on
   ``data/vids/wingsuit.avi`` (its committed frames file) with the default
   model, ``--niter 2 --pconv --pconv-all --pfuse``, all ten scales: each
   step's wall time, peak memory and launches printed, 137/4/80/75
   launches and no plain call per scale-9 GAN step, the JAX package's file
   set; under ``--visualize`` (the five grids at iteration 0 of each
   scale, their 4 x 5 x scale K1 launches counted apart, their time and
   the host's share printed) with the event file read back (every step's
   scalars, ten image values a scale); then a ``--netG`` resume (scale 9
   again, 10 amps kept) and one request at batch 2 from the run through
   ``SamplerSession`` (45 K1 launches, finite values in [-1, 1]);
6b. the same CLI run under ``--bf16``: 137/4/80/75 bf16 launches and no
   f32 one per scale-9 GAN step;
6c. reproducible training, f32 and bf16: the CLI of 6/6b again on the
   same seed (``--save-interval 1``, no ``--visualize``), its ``netG``
   and ``netD_9`` bit-equal to 6's; the same run stopped right after its
   ``netG_mid`` write at scale 2 (the last whose T is scale 0's: the GAN
   steps draw their latent at the T of the first scale a process trains,
   the reference's quirk) and resumed from it through scale 9, bit-equal
   to the uninterrupted run; every scale-9 step's seconds printed;
7. ``python -m hpvaegan_tpu_torch.cli.generate`` in-process on the runs
   of 6 and 6b, on the card: rand (4 samples, ``--metrics``), rec
   (``--metrics``), ``--inject-scale 5`` and rand at ``--w-factor 1.5``;
   45 K1 launches a rand or rec batch and 20 an inject batch of that
   run's dtype and nothing else, each AVI read back (13 frames of the
   asked size, the samples' de-normalisation), with the time of each
   batch and each clip's write;
7b. ``python -m hpvaegan_tpu_torch.cli.serve``'s server on the run of 6
   with ``--coalesce-ms 30``: five stdio requests (written, not written,
   the same seed twice with identical files, rec), four concurrent
   unseeded one-sample requests through the coalescer (at most two
   dispatches of 45 launches), HTTP health and two requests, whose
   ``device_ms`` stays within 1.2x a stdio request's of the same size
   (all run on the server's one device thread); each response's
   ``device_ms`` and ``latency_ms`` printed, any ``ok: false`` fails;
8. the sharded path, with the ranks sharing this one card over gloo
   (NCCL refuses two ranks of a group on one device), each a process of
   this script started through the ``--distributed`` launcher's
   environment, every rank's output printed and any rank's failure
   failing the run.  These time correctness, not multi-GPU scaling:
   8a. K4 (``ops/kernels/conv3d_spmd.py``) on 1x2 and 2x2 meshes at the
       critic's (4, 13, 144, 256, 64), f32 and bf16: y, dx and dw summed
       over the ranks against K1 on the whole volume and against the
       plain composition; per rank the K4 call, the exchange, the plain
       composition and ``F.conv3d`` on the haloed block with all ranks at
       once, and K1 and ``F.conv3d`` on the haloed block alone, beside
       K1's bound on that block;
   8b. ``cli.train_video --spmd --mesh-shape 1x2 --distributed --pconv
       --pconv-all`` on the clip, two ranks, all ten scales at ``--niter
       2``, f32 and ``--bf16``: per rank each step's time, peak memory and
       launches (145 K4 / K1-fwd, 80 K1-dx, 75 K1-dw a scale-9 GAN step);
       the first scale-9 GAN step's metrics and its gradients before the
       update held against a single-process ``train_scale`` from the same
       scale-8 checkpoint (no ``--pfuse``, which ``--spmd`` turns off);
9. evaluation on the card: ``cli.generate --svfid`` on the runs of 6 and
   6b (four rand samples each, the C3D trunk built afresh in each call,
   its random weights drawn as the JAX package draws them) and
   ``svfid(...)`` on the same samples, against the real top-scale clip
   (13x144x256): every score finite and > 0, the real clip against
   itself below 1e-3 of the smallest, 90 K1 launches a call (the
   sampler's; C3D runs cuDNN); the card's C3D statistics of the real
   clip and one sample's SVFID against the CPU's (within 1e-4 of the
   largest entry, SVFID within 1e-3); ms a scored sample with the
   trunk's build and without;
10. the 2D image path at full width: frame 0 of the clip's frames file
   written as a PNG by the port's writer; the 2D generator at full
   widths on a small pyramid on the card against the CPU (the tests' f32
   bar); ``cli.train_image`` on the PNG at the default geometry (nfc 64,
   latent 128, 5 layers, ten scales from 18x33 to 144x256) with
   ``--niter 2 --visualize``, f32 and ``--bf16``: each scale's seconds
   and peak memory, the file set, ten amps, the event file (every step's
   scalars, five image values a scale); ``cli.generate --image-path ...
   --sifid --metrics`` in rand and rec modes and at ``--inject-scale
   5``: four PNGs each read back equal to their samples, finite values
   in [-1, 1], the SIFID line, ms a batch; no kernel launched (the 2D
   convs are stock);
11. ``GeneratorVAE_nb`` at full width: one VAE and one GAN step of the
   full-width model on a small pyramid, the card against the CPU path
   (phase 5's bars); ``cli.train_video --generator GeneratorVAE_nb
   --pconv --pconv-all --pfuse --niter 2`` on the clip, f32 and
   ``--bf16``, ten scales, a scale-9 GAN step launching what 6's does
   (137/4/80/75: the stage stack and the critic are the same), with its
   seconds and peak memory; then ``cli.generate`` as in phase 7 on each
   run (rand, rec, ``--inject-scale 5``, ``--w-factor 1.5``);
12. the baselines at full width: one ``GeneratorCSG`` baseline step on a
   small pyramid, card against CPU; ``cli.train_video_baselines``
   (``GeneratorCSG``, the SN critic, ``--pconv --pfuse --niter 2``), f32
   and ``--bf16``, ten scales, 3 K1-fwd, 6 K2, 15 K1-dx and 10 K1-dw a
   scale-9 step (the VALID stages have no route; the critic runs apart on
   the real and the fake batch, and frozen on the generator's fake), the
   file set with ``Z_init``, in f32 a ``--netG`` resume that reloads
   ``Z_init``; ``cli.generate`` rand and rec (from ``Z_init``) on each,
   no launch, ``--inject-scale`` raising; one f32 ``GeneratorSG`` +
   ``WDiscriminatorBaselines`` run, which launches no kernel;
13. a ``{"kernels": [...]}`` line (thirteen rows: four kernels in f32 and
   in bf16 and K4 in both, each with its launches over the main-path
   runs, and K3's three instances with their own phase's), the card
   line, and last ``{"ok": true, "device": {...}}``.

Phases 6c, 11 and 12 run after 6b, before 7; phases 9 and 10 after 7b,
before 8.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet, dense):
# f32 outside the tensor cores, bf16 on the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain version: max |y_kernel - y_plain| <= KERNEL_TOL * max(1, max|y_plain|)
# (both f32; only the summation order differs)
KERNEL_TOL = 1e-4
# bf16 kernel vs its plain version: the same bf16 products, f32 sums in
# another order, one rounding to bf16, so an output may take the
# neighbouring bf16 value: 1 ulp, at most 2**-7 of max(1, max|y_plain|).
# Outputs of a second conv over an earlier output's 1-ulp flips (K2's y,
# the pair's dx): 2 ulp.  dw is f32 from identical bf16 products:
# KERNEL_TOL.
BF16_TOL, BF16_TOL2 = 2.0 ** -7, 2.0 ** -6
# card vs CPU path of a bf16 GAN step (losses, BN statistics, u/v: means
# over the flips): the JAX package's bf16 bar (tests/test_pconv.py:49-57),
# of max(1, max|ref|).  The bf16 sample's bar is measured
# (check_card_against_cpu).
BF16_MODEL_BAR = 5e-2
# card vs CPU path of the whole generator (the tests' f32 bar)
RTOL, ATOL = 2e-3, 2e-4

MAIN_CFG = dict(nfc=64, latent_dim=128, num_layer=5, enc_blocks=2,
                vae_levels=3, img_size=256, min_size=32, max_size=256,
                sampling_rates=(4, 3, 2, 1), pconv_all=True,
                video_path="data/vids/wingsuit.avi")
CLIP_AR, CLIP_FPS = 144 / 256, 24.0   # data/vids/wingsuit.avi
SCALE, BATCH, REQUESTS = 9, 2, 3
TOP_SHAPE = (BATCH, 13, 144, 256, 64)
CRITIC_SHAPE = (2 * BATCH, 13, 144, 256, 64)   # the critic on [real, fake]
SMALL_SHAPE = (1, 3, 9, 7, 64)                 # ragged in every tile
# every edge of the tilings of K1-dw bf16 (128-pixel row tiles), K2 f32
# (8 x 16 output tiles), K1-fwd bf16 (8 x 64) and K2 bf16 (6 x 28): W 1,
# 28, 29, 57, 63, 64, 65, 129, 256; H 1, 6, 7, 8, 9, 13, 144; T 1, 2, 3,
# 13; B 1, 2, 3
EDGE_SHAPES = [(1, 1, 1, 1, 64), (3, 2, 7, 63, 64), (1, 13, 7, 65, 64),
               (1, 2, 144, 129, 64), (3, 1, 1, 256, 64), (1, 13, 144, 1, 64),
               (1, 2, 8, 64, 64), (2, 3, 9, 28, 64), (1, 2, 6, 29, 64),
               (3, 1, 13, 57, 64)]
TRAIN_FLAGS = dict(pconv=True, pconv_all=True, pfuse=True)
VAE_SCALE, VAE_ITERS, GAN_ITERS = 2, 2, 3
# launches of one scale-9 GAN step under --pconv --pconv-all --pfuse
# (num_layer 5: per stage 5 K1 convs; the critic body two K2 pairs and
# one K1 block; see PERF.md):
GAN_STEP_LAUNCHES = {
    # 45 critic-step fake + 1 critic + 90 generator rec/rand + 1 critic
    # on the generator's fake
    "conv3d64_fwd": 137,
    # 2 pairs in the critic step, 2 in the generator step
    "conv3d64_pair": 4,
    # 5 in the critic step (2 per pair + 1), 5 through the frozen critic,
    # 70 in stages 2-8 of the two generator forwards (the detach at
    # vae_levels cuts stages 0-1 off)
    "conv3d64_dx": 80,
    # 5 critic (critic step only: frozen in the generator step) + 70
    # generator
    "conv3d64_dw": 75,
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def kernel_device_ms(fn, kernel: str, iters: int):
    """Mean device time of the CUDA kernel named ``kernel`` over ``iters``
    calls of ``fn``, from torch.profiler (no host time in it); None when
    the profiler records no device time for it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in p.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if e.device_type != DeviceType.CPU and kernel in e.key and t > 0:
            return t / 1e3 / e.count
    return None


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of ``flops`` at ``peak`` (the f32
    FMA rate by default) and the time to move ``nbytes`` once."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def voxels(shape) -> int:
    return shape[0] * shape[1] * shape[2] * shape[3]


def k1_bound(shape, bias: bool = True, bf16: bool = False):
    """One conv: 2*27*64*64 FLOP per voxel; x, w (and b) read once, y
    written once, in f32 or bf16 (then at the bf16 tensor-core rate)."""
    v, e = voxels(shape), 2 if bf16 else 4
    return bound(2 * 27 * 64 * 64 * v,
                 e * (2 * v * 64 + 27 * 64 * 64 + 64 * bias),
                 PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def dw_bound(shape, bf16: bool = False):
    """The weight gradient: the forward's FLOPs; x and dy read once (f32
    or bf16), dw written once (f32)."""
    v, e = voxels(shape), 2 if bf16 else 4
    return bound(2 * 27 * 64 * 64 * v, e * 2 * v * 64 + 4 * 27 * 64 * 64,
                 PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def pair_bound(shape, with_mid: bool = False, bf16: bool = False):
    """Two convs' FLOPs; x read once, y (and z) written once, the two
    weights and biases read once."""
    v, e = voxels(shape), 2 if bf16 else 4
    return bound(2 * 2 * 27 * 64 * 64 * v,
                 e * ((2 + with_mid) * v * 64 + 2 * (27 * 64 * 64 + 64)),
                 PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def check_close(what: str, got, ref, tol: float = KERNEL_TOL) -> float:
    """max |got - ref| against tol * max(1, max|ref|), in the same dtype;
    fails the run on a miss or a non-finite value."""
    import torch
    torch.cuda.synchronize()
    if got.dtype != ref.dtype:
        fail(f"{what}: {got.dtype} against a {ref.dtype} plain version")
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"{what}: max_abs_err {err:.3e} (tolerance "
          f"{tol * scale:.3e})", flush=True)
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        fail(f"{what} disagrees with its plain version")
    return err


def conv_inputs(dev, g, shape):
    """x like the model's activations, w and b at the model's init scale."""
    import torch
    scale = 1.0 / (27 * 64) ** 0.5
    x = torch.randn(shape, device=dev, generator=g)
    w = (torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2
         - 1) * scale
    b = (torch.rand(64, device=dev, generator=g) * 2 - 1) * scale
    return x, w, b


def ncdhw(t):
    """NTHWC -> the NCDHW channels_last_3d view cuDNN takes."""
    return t.permute(0, 4, 1, 2, 3)


def oi(w):
    """THWIO -> torch's (O, I, 3, 3, 3)."""
    import torch
    return w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def print_kernel_share(tracer) -> None:
    """Device time of each port kernel in a profile, and its share of the
    device time of the whole window."""
    from torch.autograd import DeviceType
    # kernels only: an op's own row counts the kernels it launched again
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in tracer.key_averages()
            if e.device_type != DeviceType.CPU]
    total = sum(t for _, t, _ in rows)
    for key, t, n in sorted(rows, key=lambda r: -r[1]):
        if "conv3d" in key and t > 0:
            name = key.replace("(anonymous namespace)::", "").split("(")[0]
            print(f"  port kernel {name}: {t / 1e3:.3f} ms device time over "
                  f"{n} launches, {100 * t / total:.2f}% of {total / 1e3:.3f} "
                  f"ms", flush=True)


def ptxas_kernels(report: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    ``-Xptxas -v`` lines; a kernel with setmaxnreg reports its launch
    count (warpgroups then trade registers)."""
    import re
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the length-prefixed name inside the mangled one
            short = re.search(r"\d+(conv3d\w+?)E", m.group(1))
            cur = short.group(1) if short else m.group(1)
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def kernel_row(name, source, replaces, err, ms, plain_ms, bound_ms_by,
               library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: kernel against plain version
# ---------------------------------------------------------------------------

def check_k1(dev):
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

    g = torch.Generator(device=dev).manual_seed(1234)
    bound = 1.0 / (27 * 64) ** 0.5   # the model's init scale
    worst, top = 0.0, None
    for shape in (TOP_SHAPE, (1, 3, 9, 7, 64)):
        x = torch.randn(shape, device=dev, generator=g)
        w = (torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2
             - 1) * bound
        b = (torch.rand(64, device=dev, generator=g) * 2 - 1) * bound
        for slope in (None, 0.2):
            y = cp.conv3d64(x, w, b, neg_slope=slope)
            ref = cp.conv3d64_plain(x, w, b, neg_slope=slope)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            ok = bool(torch.isfinite(y).all()) and err <= KERNEL_TOL * scale
            print(f"K1 {shape} lrelu={slope}: max_abs_err {err:.3e} "
                  f"(tolerance {KERNEL_TOL * scale:.3e})", flush=True)
            if not ok:
                fail(f"K1 disagrees with its plain version at {shape}")
            worst = max(worst, err)
        if shape == TOP_SHAPE:
            top = (x, w, b)

    x, w, b = top
    x_ncdhw = x.permute(0, 4, 1, 2, 3)            # channels_last_3d view
    w_oi = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib = F.conv3d(x_ncdhw, w_oi, b, padding=1).permute(0, 2, 3, 4, 1)
    lib_err = float((lib - cp.conv3d64(x, w, b)).abs().max())
    ms = time_ms(lambda: cp.conv3d64(x, w, b), iters=20)
    plain_ms = time_ms(lambda: cp.conv3d64_plain(x, w, b), iters=5)
    lib_ms = time_ms(lambda: F.conv3d(x_ncdhw, w_oi, b, padding=1),
                     iters=20)
    bound_ms, bound_by = k1_bound(TOP_SHAPE)
    print(f"K1 timing at {TOP_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.conv3d (cuDNN, TF32 off) {lib_ms:.4f} ms "
          f"(agrees to {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / ms:.3f} of the bound", flush=True)
    return kernel_row("conv3d64_fwd", cp.SOURCE, cp.REPLACES, worst, ms,
                      plain_ms, (bound_ms, bound_by), lib_ms)


def check_k1_dx(dev):
    """K1's input gradient: the forward kernel on flip_swap(w), no bias."""
    import torch
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

    g = torch.Generator(device=dev).manual_seed(1235)
    worst = 0.0
    for shape in (TOP_SHAPE, CRITIC_SHAPE, SMALL_SHAPE):
        dy, w, _ = conv_inputs(dev, g, shape)
        worst = max(worst, check_close(
            f"K1-dx {shape}", cp.conv3d64_dx(dy, w),
            cp.conv3d64_plain(dy, cp.flip_swap(w))))
        if shape == TOP_SHAPE:
            top = (dy, w)
    dy, w = top
    size = ncdhw(dy).shape
    lib = torch.nn.grad.conv3d_input(size, oi(w), ncdhw(dy), padding=1)
    lib_err = float((lib.permute(0, 2, 3, 4, 1)
                     - cp.conv3d64_dx(dy, w)).abs().max())
    ms = time_ms(lambda: cp.conv3d64_dx(dy, w), iters=20)
    plain_ms = time_ms(lambda: cp.conv3d64_plain(dy, cp.flip_swap(w)),
                       iters=5)
    lib_ms = time_ms(lambda: torch.nn.grad.conv3d_input(
        size, oi(w), ncdhw(dy), padding=1), iters=20)
    b = k1_bound(TOP_SHAPE, bias=False)
    print(f"K1-dx timing at {TOP_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.nn.grad.conv3d_input (cuDNN, TF32 "
          f"off) {lib_ms:.4f} ms (agrees to {lib_err:.3e}), bound "
          f"{b[0]:.4f} ms ({b[1]}), {b[0] / ms:.3f} of the bound",
          flush=True)
    return kernel_row("conv3d64_dx", cp.SOURCE, cp.DX_REPLACES, worst, ms,
                      plain_ms, b, lib_ms)


def check_k1_dw(dev):
    """K1's weight gradient at the critic's and the top stage's shapes."""
    import torch
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

    g = torch.Generator(device=dev).manual_seed(1236)
    worst, timed = 0.0, {}
    for shape in (CRITIC_SHAPE, TOP_SHAPE, SMALL_SHAPE):
        x, _, _ = conv_inputs(dev, g, shape)
        dy = torch.randn(shape, device=dev, generator=g)
        dw = cp.conv3d64_dw(x, dy)
        worst = max(worst, check_close(f"K1-dw {shape}", dw,
                                       cp.conv3d64_dw_plain(x, dy)))
        if not torch.equal(dw, cp.conv3d64_dw(x, dy)):
            fail(f"K1-dw {shape} differs from run to run")
        if shape == SMALL_SHAPE:
            continue
        ms = time_ms(lambda: cp.conv3d64_dw(x, dy), iters=10)
        b = dw_bound(shape)
        print(f"K1-dw timing at {shape}: kernel {ms:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), {b[0] / ms:.3f} of the bound",
              flush=True)
        timed[shape] = (x, dy, ms, b)
    x, dy, ms, b = timed[CRITIC_SHAPE]
    wsize = (64, 64, 3, 3, 3)
    lib = torch.nn.grad.conv3d_weight(ncdhw(x), wsize, ncdhw(dy), padding=1)
    lib_err = float((lib.permute(2, 3, 4, 1, 0)
                     - cp.conv3d64_dw(x, dy)).abs().max())
    plain_ms = time_ms(lambda: cp.conv3d64_dw_plain(x, dy), iters=5)
    lib_ms = time_ms(lambda: torch.nn.grad.conv3d_weight(
        ncdhw(x), wsize, ncdhw(dy), padding=1), iters=10)
    print(f"K1-dw at {CRITIC_SHAPE}: plain {plain_ms:.4f} ms, "
          f"torch.nn.grad.conv3d_weight (cuDNN, TF32 off) {lib_ms:.4f} ms "
          f"(agrees to {lib_err:.3e})", flush=True)
    return kernel_row("conv3d64_dw", cp.DW_SOURCE, cp.DW_REPLACES, worst, ms,
                      plain_ms, b, lib_ms)


def check_k2(dev):
    """K2 at the critic's shape: y, (y, z) and the backward against the
    plain pair; timed against the unfused pair on cuDNN."""
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf

    g = torch.Generator(device=dev).manual_seed(1237)
    worst = 0.0
    for shape in [CRITIC_SHAPE, SMALL_SHAPE, (1, 1, 8, 14, 64)] + EDGE_SHAPES:
        x, w1, b1 = conv_inputs(dev, g, shape)
        _, w2, b2 = conv_inputs(dev, g, shape)
        y_ref, z_ref = cf.conv3d64_pair_plain(x, w1, b1, w2, b2,
                                              with_mid=True)
        y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
        worst = max(worst, check_close(f"K2 y {shape}", y, y_ref),
                    check_close(f"K2 z {shape}", z, z_ref),
                    check_close(f"K2 y without mid {shape}",
                                cf.conv3d64_pair_forward(x, w1, b1, w2, b2),
                                y_ref))
        del y_ref, z_ref, y, z
        if shape == CRITIC_SHAPE:
            args = (x, w1, b1, w2, b2)
    # the backward (K1-dx and K1-dw through both LeakyReLU masks) against
    # the plain versions on the same x, z, y: masks from another forward
    # flip wherever a pre-activation rounds to the other side of zero
    leaves = [t.detach().requires_grad_(True) for t in args]
    dy = torch.randn(CRITIC_SHAPE, device=dev, generator=g)
    got = torch.autograd.grad(cf.conv3d64_pair(*leaves), leaves, dy)
    y, z = cf.conv3d64_pair_forward(*args, with_mid=True)
    ref = cf.conv3d64_pair_backward(args[0], z, y, args[1], args[3], dy,
                                    plain=True)
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref):
        worst = max(worst, check_close(f"K2 backward {name}", a, r))
    del got, ref, y, z

    x, w1, b1, w2, b2 = args
    ms = time_ms(lambda: cf.conv3d64_pair_forward(*args), iters=5)
    mid_ms = time_ms(lambda: cf.conv3d64_pair_forward(*args, with_mid=True),
                     iters=5)
    y_fn = cf.conv3d64_pair(*leaves)
    bwd_ms = time_ms(lambda: torch.autograd.grad(y_fn, leaves, dy,
                                                 retain_graph=True), iters=3)
    plain_ms = time_ms(lambda: cf.conv3d64_pair_plain(*args), iters=2)
    xc, w1c, w2c = ncdhw(x), oi(w1), oi(w2)

    def unfused():
        z = F.leaky_relu(F.conv3d(xc, w1c, b1, padding=1), 0.2)
        return F.leaky_relu(F.conv3d(z, w2c, b2, padding=1), 0.2)

    unfused_err = float((unfused().permute(0, 2, 3, 4, 1)
                         - cf.conv3d64_pair_forward(*args)).abs().max())
    unfused_ms = time_ms(unfused, iters=10)
    b, b_mid = pair_bound(CRITIC_SHAPE), pair_bound(CRITIC_SHAPE, True)
    print(f"K2 timing at {CRITIC_SHAPE}: kernel {ms:.4f} ms (with z "
          f"{mid_ms:.4f} ms, bound {b_mid[0]:.4f} ms), backward "
          f"{bwd_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}), {b[0] / ms:.3f} of the bound", flush=True)
    print(f"K2 unfused pair (two F.conv3d + LeakyReLU, cuDNN, TF32 off) at "
          f"{CRITIC_SHAPE}: {unfused_ms:.4f} ms (agrees to "
          f"{unfused_err:.3e})", flush=True)
    # no single library call computes the pair: the unfused cuDNN pair is
    # its yardstick, beside library_ms
    return {**kernel_row("conv3d64_pair", cf.SOURCE, cf.REPLACES, worst, ms,
                         plain_ms, b, None), "unfused_ms": unfused_ms}


# ---------------------------------------------------------------------------
# phase 3b: the bf16 kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_inputs(dev, g, shape):
    """bf16 activations; f32 weights and biases (the parameters stay f32
    under --bf16: the wrappers round them)."""
    import torch
    x, w, b = conv_inputs(dev, g, shape)
    return x.to(torch.bfloat16), w, b


def check_k1_bf16(dev):
    """K1's forward, dx and dw in bf16 at the top stage's and the critic's
    shapes; yardsticks: cuDNN's bf16 conv and its two gradients."""
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2234)
    worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    data = {}
    for shape in (TOP_SHAPE, CRITIC_SHAPE, SMALL_SHAPE):
        x, w, b = bf16_inputs(dev, g, shape)
        dy = torch.randn(shape, device=dev, generator=g).to(bf)
        for slope in (None, 0.2):
            worst["fwd"] = max(worst["fwd"], check_close(
                f"K1 bf16 {shape} lrelu={slope}",
                cp.conv3d64(x, w, b, neg_slope=slope),
                cp.conv3d64_plain(x, w, b, neg_slope=slope), BF16_TOL))
        worst["dx"] = max(worst["dx"], check_close(
            f"K1-dx bf16 {shape}", cp.conv3d64_dx(dy, w),
            cp.conv3d64_plain(dy, cp.flip_swap(w)), BF16_TOL))
        dw = cp.conv3d64_dw(x, dy)
        worst["dw"] = max(worst["dw"], check_close(
            f"K1-dw bf16 {shape}", dw, cp.conv3d64_dw_plain(x, dy)))
        if not torch.equal(dw, cp.conv3d64_dw(x, dy)):
            fail(f"K1-dw bf16 {shape} differs from run to run")
        data[shape] = (x, w, b, dy)
    for shape in EDGE_SHAPES:   # the edges of the wgmma kernels' tilings
        x, w, b = bf16_inputs(dev, g, shape)
        dy = torch.randn(shape, device=dev, generator=g).to(bf)
        for slope in (None, 0.2):
            worst["fwd"] = max(worst["fwd"], check_close(
                f"K1 bf16 {shape} lrelu={slope}",
                cp.conv3d64(x, w, b, neg_slope=slope),
                cp.conv3d64_plain(x, w, b, neg_slope=slope), BF16_TOL))
        worst["dx"] = max(worst["dx"], check_close(
            f"K1-dx bf16 {shape}", cp.conv3d64_dx(dy, w),
            cp.conv3d64_plain(dy, cp.flip_swap(w)), BF16_TOL))
        dw = cp.conv3d64_dw(x, dy)
        worst["dw"] = max(worst["dw"], check_close(
            f"K1-dw bf16 {shape}", dw, cp.conv3d64_dw_plain(x, dy)))
        if not torch.equal(dw, cp.conv3d64_dw(x, dy)):
            fail(f"K1-dw bf16 {shape} differs from run to run")

    # the forward at the serving path's ten stage shapes, batch 2
    for idx, stage in enumerate(main_config().pyramid().all_shapes3d()):
        shape = (BATCH, *stage, 64)
        x, w, b = bf16_inputs(dev, g, shape)
        worst["fwd"] = max(worst["fwd"], check_close(
            f"K1 bf16 stage {idx} {shape}", cp.conv3d64(x, w, b, 0.2),
            cp.conv3d64_plain(x, w, b, 0.2), BF16_TOL))
        call = lambda: cp.conv3d64(x, w, b, 0.2)  # noqa: E731
        ms = time_ms(call, iters=20)
        dev_ms = kernel_device_ms(call, "conv3d64_fwd_bf16_kernel", iters=20)
        bd = k1_bound(shape, bf16=True)
        kernel = ("not measured (the profiler saw no device time)"
                  if dev_ms is None else
                  f"{dev_ms:.4f} ms, {bd[0] / dev_ms:.3f} of the bound")
        print(f"K1 bf16 timing at stage {idx} {shape}: wrapper {ms:.4f} ms "
              f"(CUDA events; host-bound where the card waits for the "
              f"call), kernel alone {kernel} (profiler device time), bound "
              f"{bd[0]:.4f} ms ({bd[1]})", flush=True)

    rows = []
    x, w, b, dy = data[TOP_SHAPE]
    wb, bb = w.to(bf), b.to(bf)
    lib_fwd = lambda: F.conv3d(ncdhw(x), oi(wb), bb, padding=1)  # noqa: E731
    ms = time_ms(lambda: cp.conv3d64(x, w, b), iters=20)
    plain_ms = time_ms(lambda: cp.conv3d64_plain(x, w, b), iters=5)
    lib_ms = time_ms(lib_fwd, iters=20)
    bd = k1_bound(TOP_SHAPE, bf16=True)
    print(f"K1 bf16 timing at {TOP_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.conv3d bf16 (cuDNN) {lib_ms:.4f} ms, bound "
          f"{bd[0]:.4f} ms ({bd[1]}), {bd[0] / ms:.3f} of the bound",
          flush=True)
    rows.append(kernel_row("conv3d64_fwd_bf16", cp.SOURCE, cp.REPLACES,
                           worst["fwd"], ms, plain_ms, bd, lib_ms))

    size = ncdhw(dy).shape
    ms = time_ms(lambda: cp.conv3d64_dx(dy, w), iters=20)
    plain_ms = time_ms(lambda: cp.conv3d64_plain(dy, cp.flip_swap(w)),
                       iters=5)
    lib_ms = time_ms(lambda: torch.nn.grad.conv3d_input(
        size, oi(wb), ncdhw(dy), padding=1), iters=20)
    bd = k1_bound(TOP_SHAPE, bias=False, bf16=True)
    print(f"K1-dx bf16 timing at {TOP_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.nn.grad.conv3d_input bf16 (cuDNN) "
          f"{lib_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
          f"{bd[0] / ms:.3f} of the bound", flush=True)
    rows.append(kernel_row("conv3d64_dx_bf16", cp.SOURCE, cp.DX_REPLACES,
                           worst["dx"], ms, plain_ms, bd, lib_ms))

    for shape in (TOP_SHAPE, CRITIC_SHAPE):
        x, _, _, dy = data[shape]
        ms = time_ms(lambda: cp.conv3d64_dw(x, dy), iters=10)
        bd = dw_bound(shape, bf16=True)
        print(f"K1-dw bf16 timing at {shape}: kernel {ms:.4f} ms, bound "
              f"{bd[0]:.4f} ms ({bd[1]}), {bd[0] / ms:.3f} of the bound",
              flush=True)
    plain_ms = time_ms(lambda: cp.conv3d64_dw_plain(x, dy), iters=5)
    lib_ms = time_ms(lambda: torch.nn.grad.conv3d_weight(
        ncdhw(x), (64, 64, 3, 3, 3), ncdhw(dy), padding=1), iters=10)
    print(f"K1-dw bf16 at {CRITIC_SHAPE}: plain {plain_ms:.4f} ms, "
          f"torch.nn.grad.conv3d_weight bf16 (cuDNN) {lib_ms:.4f} ms",
          flush=True)
    rows.append(kernel_row("conv3d64_dw_bf16", cp.DW_SOURCE, cp.DW_REPLACES,
                           worst["dw"], ms, plain_ms, bd, lib_ms))
    return rows


def check_k2_bf16(dev):
    """K2 in bf16 at the critic's shape: y, (y, z) and the backward
    against the plain pair; timed against the unfused bf16 cuDNN pair."""
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2237)
    worst = 0.0
    for shape in [CRITIC_SHAPE, SMALL_SHAPE, (1, 1, 8, 14, 64)] + EDGE_SHAPES:
        x, w1, b1 = bf16_inputs(dev, g, shape)
        _, w2, b2 = conv_inputs(dev, g, shape)
        y_ref, z_ref = cf.conv3d64_pair_plain(x, w1, b1, w2, b2,
                                              with_mid=True)
        y, z = cf.conv3d64_pair_forward(x, w1, b1, w2, b2, with_mid=True)
        worst = max(worst, check_close(f"K2 bf16 y {shape}", y, y_ref,
                                       BF16_TOL2),
                    check_close(f"K2 bf16 z {shape}", z, z_ref, BF16_TOL),
                    check_close(f"K2 bf16 y without mid {shape}",
                                cf.conv3d64_pair_forward(x, w1, b1, w2, b2),
                                y_ref, BF16_TOL2))
        del y_ref, z_ref, y, z
        if shape == CRITIC_SHAPE:
            args = (x, w1, b1, w2, b2)
    leaves = [t.detach().requires_grad_(True) for t in args]
    dy = torch.randn(CRITIC_SHAPE, device=dev, generator=g).to(bf)
    got = torch.autograd.grad(cf.conv3d64_pair(*leaves), leaves, dy)
    y, z = cf.conv3d64_pair_forward(*args, with_mid=True)
    ref = cf.conv3d64_pair_backward(args[0], z, y, args[1], args[3], dy,
                                    plain=True)
    # dx: two K1-dx in a row; dw rounded to bf16; db1 sums d_pre1, which
    # carries dz's flips; db2 sums the same d_pre2 on both sides
    tols = (BF16_TOL2, BF16_TOL, BF16_TOL, BF16_TOL, KERNEL_TOL)
    for name, a, r, tol in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref,
                               tols):
        worst = max(worst, check_close(f"K2 bf16 backward {name}", a, r, tol))
    del got, ref, y, z

    x, w1, b1, w2, b2 = args
    ms = time_ms(lambda: cf.conv3d64_pair_forward(*args), iters=5)
    mid_ms = time_ms(lambda: cf.conv3d64_pair_forward(*args, with_mid=True),
                     iters=5)
    y_fn = cf.conv3d64_pair(*leaves)
    bwd_ms = time_ms(lambda: torch.autograd.grad(y_fn, leaves, dy,
                                                 retain_graph=True), iters=3)
    plain_ms = time_ms(lambda: cf.conv3d64_pair_plain(*args), iters=2)
    xc, w1c, w2c, b1c, b2c = (ncdhw(x), oi(w1.to(bf)), oi(w2.to(bf)),
                              b1.to(bf), b2.to(bf))

    def unfused():
        z = F.leaky_relu(F.conv3d(xc, w1c, b1c, padding=1), 0.2)
        return F.leaky_relu(F.conv3d(z, w2c, b2c, padding=1), 0.2)

    unfused_ms = time_ms(unfused, iters=10)
    bd, bd_mid = (pair_bound(CRITIC_SHAPE, bf16=True),
                  pair_bound(CRITIC_SHAPE, True, bf16=True))
    print(f"K2 bf16 timing at {CRITIC_SHAPE}: kernel {ms:.4f} ms (with z "
          f"{mid_ms:.4f} ms, bound {bd_mid[0]:.4f} ms), backward "
          f"{bwd_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms "
          f"({bd[1]}), {bd[0] / ms:.3f} of the bound", flush=True)
    print(f"K2 bf16 unfused pair (two F.conv3d bf16 + LeakyReLU, cuDNN) at "
          f"{CRITIC_SHAPE}: {unfused_ms:.4f} ms", flush=True)
    return {**kernel_row("conv3d64_pair_bf16", cf.SOURCE, cf.REPLACES, worst,
                         ms, plain_ms, bd, None), "unfused_ms": unfused_ms}


# ---------------------------------------------------------------------------
# phase 3c: K3, the fused conv + bias + LeakyReLU for any channel count
# ---------------------------------------------------------------------------

# (C_in, C_out) at the top stage's (2, 13, 144, 256): the encoder head's
# 3 -> 64 (narrow_in), a body conv's 64 -> 64 (wide), a tail's 64 -> 3
# (narrow_out)
K3_CHANNELS = ((3, 64), (64, 64), (64, 3))
K3_RAGGED = [((1, t, 9, 7, 5), 7) for t in (1, 2, 4)]
# every instance across its boundaries: C_in 1, 2, 3, 4 (narrow_in) and
# 5, 17, 64 (wide) into C_out 9, 64, 65, 130; C_out 1, 3, 8 (narrow_out)
# from C_in 1, 4, 5, 64; H and W off the tiles (4 x 32, 8 x 64),
# T 1, 2, 4 and longer runs of frames (narrow_out streams T)
K3_EDGES = [((1, 4, 9, 37, 1), 9), ((2, 1, 35, 67, 3), 65),
            ((1, 2, 17, 33, 4), 64), ((1, 3, 9, 37, 2), 130),
            ((1, 4, 9, 37, 5), 9), ((2, 1, 35, 67, 64), 65),
            ((1, 2, 17, 33, 5), 64), ((1, 3, 6, 35, 17), 130),
            ((1, 4, 9, 37, 64), 1), ((2, 1, 35, 67, 4), 3),
            ((1, 2, 17, 33, 5), 8), ((1, 7, 20, 70, 64), 8),
            ((1, 6, 33, 65, 1), 3)]


def k3_bound(shape, c_out: int):
    """2*27*C_in*C_out FLOP per output voxel at the f32 rate; x read once,
    y written once, w and b read once, all f32."""
    v, c_in = voxels(shape), shape[-1]
    return bound(2 * 27 * c_in * c_out * v,
                 4 * (v * (c_in + c_out) + 27 * c_in * c_out + c_out))


def k3_inputs(dev, g, shape, c_out):
    """x like the activations, w and b at the model's init scale."""
    import torch
    scale = 1.0 / (27 * shape[-1]) ** 0.5
    x = torch.randn(shape, device=dev, generator=g)
    w = (torch.rand((3, 3, 3, shape[-1], c_out), device=dev, generator=g)
         * 2 - 1) * scale
    b = (torch.rand(c_out, device=dev, generator=g) * 2 - 1) * scale
    return x, w, b


def check_k3(dev):
    """K3's own phase: one forward and backward through the differentiable
    ``conv3d_lrelu`` at each full shape (the rows' launches: one per
    instance), then each instance against its plain version at the full
    and ragged shapes, the Function's gradients against autograd through
    the plain conv, and the timings.  One row per instance."""
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3

    g = torch.Generator(device=dev).manual_seed(3234)
    full = [((BATCH, *TOP_SHAPE[1:4], c_in), c_out)
            for c_in, c_out in K3_CHANNELS]
    data = {}
    k3.counts.reset()
    for shape, c_out in full:
        leaves = [t.requires_grad_(True)
                  for t in k3_inputs(dev, g, shape, c_out)]
        torch.autograd.grad(k3.conv3d_lrelu(*leaves).square().sum(), leaves)
        data[(shape, c_out)] = [t.detach() for t in leaves]
    torch.cuda.synchronize()
    launches = dict(k3.counts.by_instance)
    print(f"K3 path (forward + backward at {len(full)} shapes): launches "
          f"{k3.counts.launches} {launches}, plain calls "
          f"{k3.counts.plain_calls}", flush=True)
    if (k3.counts.launches != len(full) or k3.counts.plain_calls
            or launches != {i: 1 for i in k3.INSTANCES}):
        fail("K3's own path did not launch each instance once")

    worst = dict.fromkeys(k3.INSTANCES, 0.0)
    for shape, c_out in full + K3_RAGGED + K3_EDGES:
        inst = k3.k3_instance(shape[-1], c_out)
        x, w, b = data.get((shape, c_out)) or k3_inputs(dev, g, shape, c_out)
        worst[inst] = max(worst[inst], check_close(
            f"K3 {inst} {shape} -> {c_out}", k3.conv3d_lrelu(x, w, b),
            k3.conv3d_lrelu_plain(x, w, b)))
        # the backward against autograd through the plain conv (slope 1:
        # no LeakyReLU) for the cotangent masked by the kernel's own y: a
        # mask from the plain forward would flip wherever an output
        # rounds to the other side of zero
        dy = torch.randn((*shape[:4], c_out), device=dev, generator=g)
        got_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = k3.conv3d_lrelu(*got_leaves)
        got = torch.autograd.grad(y, got_leaves, dy)
        d_pre = torch.where(y.detach() >= 0, dy, k3.NEG_SLOPE * dy)
        ref = torch.autograd.grad(
            k3.conv3d_lrelu_plain(*ref_leaves, neg_slope=1.0), ref_leaves,
            d_pre)
        for name, a, r in zip(("dx", "dw", "db"), got, ref):
            check_close(f"K3 {shape} -> {c_out} {name}", a, r)
        del got, ref, got_leaves, ref_leaves, y, d_pre

    rows = []
    for shape, c_out in full:
        inst = k3.k3_instance(shape[-1], c_out)
        x, w, b = data[(shape, c_out)]
        xc, wc = ncdhw(x), w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        ms = time_ms(lambda: k3.conv3d_lrelu(x, w, b), iters=10)
        plain_ms = time_ms(lambda: k3.conv3d_lrelu_plain(x, w, b), iters=5)
        lib_ms = time_ms(lambda: F.leaky_relu(F.conv3d(xc, wc, b, padding=1),
                                              0.2), iters=10)
        bd = k3_bound(shape, c_out)
        print(f"K3 timing, {inst} at {shape} -> {c_out}: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, F.conv3d + leaky_relu (cuDNN, "
              f"TF32 off) {lib_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{bd[0] / ms:.3f} of the bound", flush=True)
        row = kernel_row(f"conv3d_lrelu_{inst}", k3.SOURCE, k3.REPLACES,
                         worst[inst], ms, plain_ms, bd, None)
        row.update(launches=launches[inst], shape=[*shape, c_out],
                   cudnn_lrelu_ms=lib_ms,
                   routed="nowhere, as in the JAX package: launches of its "
                          "own phase (3c)")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_config(**over):
    from hpvaegan_tpu_torch.core.config import Config
    cfg = Config(**{**MAIN_CFG, **over})
    cfg.ar, cfg.org_fps = CLIP_AR, CLIP_FPS
    cfg.adjust_scales()
    return cfg


def build_generator(cfg, scale: int, seed: int):
    """Random weights from ``seed``, grown to ``scale`` stages, on the CPU."""
    import torch
    from hpvaegan_tpu_torch.models.registry import make_generator
    gen = torch.Generator().manual_seed(seed)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    return G


def check_card_against_cpu(dev, seed: int, bf16: bool = False) -> None:
    """Full model widths on a small pyramid: the card (K1 + cuDNN) and
    the CPU path (plain versions) on the same weights and draws.

    f32: the tests' f32 bar.  bf16: a 1-ulp rounding flip in one conv
    moves the 4-scale, 26-conv model's output far more than one ulp, so
    the bar is the model's own bf16 noise, measured here: the card's
    distance to the CPU bf16 path, in RMS and max, may not exceed the CPU
    bf16 path's distance to the CPU f32 path (the same weights and
    draws) in RMS, nor twice it in max."""
    import copy

    import numpy as np
    import torch

    cfg = main_config(img_size=48, min_size=24, max_size=48, bf16=bf16)
    scale = cfg.stop_scale
    G = build_generator(cfg, scale, seed)
    pyr = cfg.pyramid()
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((BATCH, *pyr.shape3d(0), cfg.latent_dim),
                            dtype=np.float32)
    noises = [rng.standard_normal((BATCH, *pyr.shape3d(i + 1), 3),
                                  dtype=np.float32) for i in range(scale)]
    amps = [1.0] + [cfg.noise_amp] * scale
    runs = [("cpu", G), ("cuda", copy.deepcopy(G).to(dev))]
    if bf16:
        cfg32 = main_config(img_size=48, min_size=24, max_size=48)
        runs.append(("cpu f32", build_generator(cfg32, scale, seed)))
    outs = {}
    for name, model in runs:
        reset_counts()
        with torch.inference_mode():
            out, _, _ = model.apply(amps, noise_init=z, mode="rand",
                                    train=True, noises=noises)
            outs[name] = out.float().cpu().numpy()
        print(f"small pyramid on {name} ({dtype_name(bf16)}): launches "
              f"{all_counts()}", flush=True)
    err = float(np.max(np.abs(outs["cuda"] - outs["cpu"])))
    print(f"card vs CPU path ({dtype_name(bf16)}), {pyr.all_shapes3d()[-1]} "
          f"at scale {scale}: max_abs_err {err:.3e}", flush=True)
    if bf16:
        def rms(d):
            return float(np.sqrt(np.mean(np.square(d))))
        card, noise = outs["cuda"] - outs["cpu"], outs["cpu"] - outs["cpu f32"]
        said = (f"bf16 card vs CPU bf16: rms {rms(card):.3e}, max {err:.3e}; "
                f"the bar, CPU bf16 vs CPU f32: rms {rms(noise):.3e}, max "
                f"{float(np.abs(noise).max()):.3e}")
        ok = (rms(card) <= rms(noise)
              and err <= 2 * float(np.abs(noise).max()))
    else:
        excess = np.abs(outs["cuda"] - outs["cpu"]) - (
            ATOL + RTOL * np.abs(outs["cpu"]))
        said = (f"f32 card vs CPU: max_abs_err {err:.3e}, worst excess over "
                f"atol {ATOL} + rtol {RTOL} * |CPU| {float(excess.max()):.3e}")
        ok = np.allclose(outs["cuda"], outs["cpu"], rtol=RTOL, atol=ATOL)
    print(said, flush=True)
    if not ok:
        fail(f"the generator on the card disagrees with the CPU path "
             f"({said}; CPU threads {torch.get_num_threads()}, CPU "
             f"capability {torch.backends.cpu.get_cpu_capability()})")


def serve_main_path(dev, seed: int, profile: bool, bf16: bool = False):
    """Three full-width requests from a scale-9 checkpoint whose
    config.json says ``bf16``; returns the launches of the requests."""
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    from hpvaegan_tpu_torch.utils.saver import save_generator

    cfg = main_config(bf16=bf16)
    k1 = "conv3d64_fwd_bf16" if bf16 else "conv3d64_fwd"
    shapes = cfg.pyramid().all_shapes3d()
    if shapes[0] != (4, 18, 33) or shapes[SCALE] != TOP_SHAPE[1:4]:
        fail(f"unexpected pyramid {shapes}")
    print(f"main path pyramid (T,H,W): {shapes}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        netG = os.path.join(tmp, "netG")
        t0 = time.perf_counter()
        G = build_generator(cfg, SCALE, seed)
        save_generator(netG, G, SCALE, [1.0] + [cfg.noise_amp] * SCALE)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(cfg.snapshot_dict(), f)
        del G

        scfg = Config(netG=netG, pconv_all=True)
        apply_snapshot(scfg, netG, explicit=set(), user_chose_source=False)
        if scfg.bf16 != bf16:
            fail(f"the snapshot restored bf16={scfg.bf16}, want {bf16}")
        scfg.adjust_scales()
        session = SamplerSession(scfg, batch_size=BATCH, manual_seed=seed,
                                 device=dev)
        session.warmup(("rand",))
        torch.cuda.synchronize()
        print(f"session: scale {session.scale}, built + saved + loaded + "
              f"warmed up in {time.perf_counter() - t0:.3f} s", flush=True)

    per_stage = 5 * SCALE
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    times = []
    for i in range(REQUESTS):
        before = all_counts()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = session.sample_batch()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        now = all_counts()
        launched = {k: now[k] - before[k] for k in now}
        want = (BATCH, *TOP_SHAPE[1:4], 3)
        print(f"request {i} ({dtype_name(bf16)}): {times[-1]:.3f} ms, shape "
              f"{out.shape} {out.dtype}, range [{out.min():.4f}, "
              f"{out.max():.4f}], launches {launched}", flush=True)
        if out.shape != want:
            fail(f"sample shape {out.shape}, want {want}")
        if not np.all(np.isfinite(out)) or np.abs(out).max() > 1.0:
            fail("sample not finite or outside [-1, 1]")
        if launched != {**{k: 0 for k in launched}, k1: per_stage}:
            fail(f"a request launched {launched}, want {per_stage} {k1} "
                 f"and nothing else")
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"main path ({dtype_name(bf16)}): {REQUESTS} requests, ms per "
          f"request {times}, peak memory {peak} bytes", flush=True)

    # K1's share of a request: its 45 launches timed at their shapes
    from hpvaegan_tpu_torch.ops.kernels.conv3d_pack import conv3d64
    w = torch.zeros((3, 3, 3, 64, 64), device=dev)
    b = torch.zeros(64, device=dev)
    k1_total = 0.0
    for idx in range(1, SCALE + 1):
        x = torch.randn((BATCH, *shapes[idx], 64), device=dev).to(
            torch.bfloat16 if bf16 else torch.float32)
        k1_total += 5 * time_ms(lambda: conv3d64(x, w, b), iters=10)
    print(f"K1 ({dtype_name(bf16)}) time per request (45 launches at the "
          f"stage shapes): {k1_total:.4f} ms of {min(times):.3f} ms",
          flush=True)

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            session.sample_batch()
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=15), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the training path
# ---------------------------------------------------------------------------

def dtype_name(bf16: bool) -> str:
    return "bf16" if bf16 else "f32"


def all_counts() -> dict:
    """Launches per kernel row (f32 and bf16 apart) and plain calls."""
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    c = cp.counts
    return {"conv3d64_fwd": c.fwd_launches,
            "conv3d64_dx": c.dx_launches,
            "conv3d64_dw": c.dw_launches,
            "conv3d64_pair": cf.counts.launches,
            "conv3d64_fwd_bf16": c.fwd_bf16_launches,
            "conv3d64_dx_bf16": c.dx_bf16_launches,
            "conv3d64_dw_bf16": c.dw_bf16_launches,
            "conv3d64_pair_bf16": cf.counts.bf16_launches,
            "plain": c.plain_calls + cf.counts.plain_calls}


def reset_counts() -> None:
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    cp.counts.reset()
    cf.counts.reset()


def check_train_card_against_cpu(dev, seed: int, bf16: bool = False) -> None:
    """One GAN step of the full-width model (critic included) on a small
    pyramid, on the card and on the CPU path, from the same weights and
    draws: losses, BN running statistics and spectral u/v agree, in f32
    (the tests' f32 bar) or bf16 (the JAX package's bf16 bar)."""
    import copy

    import numpy as np
    import torch
    from hpvaegan_tpu_torch.models.registry import make_discriminator
    from hpvaegan_tpu_torch.train import optim, steps

    cfg = main_config(img_size=48, min_size=24, max_size=48, bf16=bf16,
                      **TRAIN_FLAGS)
    scale = cfg.vae_levels                      # the first GAN scale
    cfg.scale_idx = scale
    pyr = cfg.pyramid()
    G = build_generator(cfg, scale, seed).requires_grad_(True)
    D = make_discriminator(cfg.discriminator, cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    real = np.tanh(draw(BATCH, *pyr.shape3d(scale), 3))
    real_zero = np.tanh(draw(BATCH, *pyr.shape3d(0), 3))
    noise_init = draw(BATCH, *pyr.shape3d(0), cfg.latent_dim)
    noises = [draw(BATCH, *pyr.shape3d(i + 1), 3) for i in range(scale)]
    eps = draw(BATCH, *pyr.shape3d(0), cfg.latent_dim)
    amps = [1.0] + [cfg.noise_amp] * scale
    runs = {}
    for name, (g, d) in (("cpu", (G, D)),
                         ("cuda", (copy.deepcopy(G).to(dev),
                                   copy.deepcopy(D).to(dev)))):
        reset_counts()
        metrics = steps.gan_step(
            g, d, optim.build_g_optimizer(cfg, g, scale),
            optim.build_d_optimizer(cfg, d), cfg, real, real_zero,
            noise_init, amps, noises=noises, eps=eps, alpha=0.37)
        bufs = {f"G.{k}": v.cpu().numpy() for k, v in g.named_buffers()}
        bufs.update({f"D.{k}": v.cpu().numpy() for k, v in d.named_buffers()})
        runs[name] = ({k: float(v) for k, v in metrics.items()}, bufs)
        print(f"small-pyramid GAN step on {name} ({dtype_name(bf16)}): "
              f"{runs[name][0]}, launches {all_counts()}", flush=True)
    (m_cpu, b_cpu), (m_gpu, b_gpu) = runs["cpu"], runs["cuda"]
    worst = 0.0
    for key in list(m_cpu) + list(b_cpu):
        a = np.asarray(m_gpu[key] if key in m_gpu else b_gpu[key])
        b = np.asarray(m_cpu[key] if key in m_cpu else b_cpu[key])
        err = float(np.max(np.abs(a - b)))
        if bf16:
            ok = err <= BF16_MODEL_BAR * max(1.0, float(np.abs(b).max()))
        else:
            ok = np.allclose(a, b, rtol=RTOL, atol=ATOL)
        if not ok:
            fail(f"GAN step on the card disagrees with the CPU path in {key}:"
                 f" {err:.3e}")
        worst = max(worst, err)
    print(f"card vs CPU GAN step ({dtype_name(bf16)}) at scale {scale} "
          f"{pyr.shape3d(scale)}: losses, BN statistics and u/v agree, "
          f"max_abs_err {worst:.3e}", flush=True)


def train_main_path(dev, seed: int, profile: bool, bf16: bool = False):
    """``train_scale`` at full width: scale 2 (VAE) and scale 9 (GAN),
    with ``--bf16`` or not.  Returns the launches of the whole run, per
    kernel row.  ``profile``: a torch.profiler table of the scale-9 run."""
    sfx = "_bf16" if bf16 else ""
    # per GAN step: GAN_STEP_LAUNCHES of this dtype's kernels, none of the
    # other dtype's
    want_step = {f"{k}{other}": (n if other == sfx else 0)
                 for k, n in GAN_STEP_LAUNCHES.items()
                 for other in ("", "_bf16")}
    import torch
    from hpvaegan_tpu_torch.train.trainer import train_scale

    def clips(pyr, scale):
        """(real, real_zero) batches at the pyramid's shapes, from seed."""
        g = torch.Generator(device=dev).manual_seed(seed + scale)
        while True:
            yield tuple(torch.tanh(torch.randn(
                (BATCH, *pyr.shape3d(s), 3), device=dev, generator=g))
                for s in (scale, 0))

    reset_counts()
    for scale, iters in ((VAE_SCALE, VAE_ITERS), (SCALE, GAN_ITERS)):
        cfg = main_config(niter=iters, bf16=bf16, **TRAIN_FLAGS)
        cfg.scale_idx = scale
        cfg.Noise_Amps = [1.0] + [cfg.noise_amp] * (scale - 1)
        G = build_generator(cfg, scale, seed).to(dev)
        gan = cfg.vae_levels < scale + 1
        state = {"t": 0.0, "counts": None}

        def mark():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            state["t"], state["counts"] = time.perf_counter(), all_counts()

        def on_event(event, it, info):
            torch.cuda.synchronize()
            wall = time.perf_counter() - state["t"]
            now = all_counts()
            delta = {k: now[k] - state["counts"][k] for k in now}
            peak = torch.cuda.max_memory_allocated(dev)
            values = {k: float(v) for k, v in info.items()}
            print(f"scale {scale} ({dtype_name(bf16)}) {event} {it}: "
                  f"{wall:.4f} s, {values}, peak memory {peak} bytes, "
                  f"launches {delta}", flush=True)
            if not all(math.isfinite(v) for v in values.values()):
                fail(f"scale {scale} {event} {it}: a loss is not finite")
            if delta["plain"]:
                fail(f"the plain versions ran {delta['plain']} times")
            if gan and event == "step":
                for name, want in want_step.items():
                    if delta[name] != want:
                        fail(f"{name} launched {delta[name]} times in a "
                             f"scale-{scale} GAN step, want {want}")
            mark()

        mark()
        tracer = contextlib.nullcontext()
        if profile and gan:
            from torch.profiler import ProfilerActivity, profile as prof
            tracer = prof(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA],
                          record_shapes=True)
        with tracer:
            _, D, hist = train_scale(cfg, G, clips(cfg.pyramid(), scale),
                                     seed=seed, callback=on_event)
        if profile and gan:
            print(f"profile of train_scale at scale {scale} "
                  f"({dtype_name(bf16)}, calibration + {iters} steps):",
                  flush=True)
            print(tracer.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25), flush=True)
            print_kernel_share(tracer)
            print("the same by input shapes:", flush=True)
            print(tracer.key_averages(group_by_input_shape=True).table(
                sort_by="cuda_time_total", row_limit=25), flush=True)
        if len(hist) != iters or (D is not None) != gan:
            fail(f"train_scale at scale {scale} ran {len(hist)} steps")
        del G, D, hist
        torch.cuda.empty_cache()
    return all_counts()


# ---------------------------------------------------------------------------
# phase 6: the training entry point
# ---------------------------------------------------------------------------

CLI_FILES = (["netG", "Noise_Amps", "Noise_Amps.json", "config.json",
              "logbook.txt", "eval"]
             + [f"netD_{s}" for s in range(MAIN_CFG["vae_levels"], SCALE + 1)])
# the five grids of --visualize, each an unfolded frame grid and a clip
VIS_IMAGES = 10
INJECT_SCALE = 5    # phase 7's --inject-scale
# the 3 rand samples and the reconstruction of --visualize
VIS_FORWARDS = 4


def experiment_dir(run_dir) -> Path:
    return Path(run_dir) / "wingsuit" / "DEBUG" / "experiment_0"


def check_events(exp: Path, want_scalars: dict,
                 n_images: int = VIS_IMAGES) -> None:
    """The event file of a --visualize CLI run: every step's scalars
    (``want_scalars[scale]`` values an iteration, both iterations) and
    the ``n_images`` image values of every scale at iteration 0."""
    from collections import Counter

    from hpvaegan_tpu_torch.utils.tb_events import read_events
    files = list(exp.glob("events.out.tfevents.*"))
    if len(files) != 1:
        fail(f"want one event file in {exp}, found {files}")
    t0 = time.perf_counter()
    events = read_events(str(files[0]))
    read_s = time.perf_counter() - t0
    scalars, images = Counter(), Counter()
    for e in events:
        for tag, kind, _ in e["values"]:
            scale = int(tag.split("/")[1].split("_")[1])
            (scalars if kind == "scalar" else images)[(scale, e["step"])] += 1
    print(f"events file {files[0].name}: {files[0].stat().st_size} bytes, "
          f"{len(events)} events, {sum(scalars.values())} scalar values, "
          f"{sum(images.values())} image values (read with CRC checks in "
          f"{read_s:.3f} s)", flush=True)
    want_s = Counter({(s, it): n for s, n in want_scalars.items()
                      for it in range(2)})
    want_i = Counter({(s, 0): n_images for s in want_scalars})
    if scalars != want_s or images != want_i:
        fail(f"the event file holds scalars {dict(scalars)} and images "
             f"{dict(images)}, want {dict(want_s)} and {dict(want_i)}")


def train_cli_main_path(dev, seed: int, run_dir, bf16: bool = False):
    """``hpvaegan_tpu_torch.cli.train_video`` at full width on the in-repo
    clip, all ten scales with ``--niter 2 --visualize`` (the grids at
    iteration 0 of each scale) and ``--bf16`` or not; in f32 also a
    ``--netG`` resume and one request from the run.  Returns the
    launches of the runs; the run stays in ``run_dir``."""
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.cli import train_video
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    from hpvaegan_tpu_torch.utils.logger import kept_logging

    sfx = "_bf16" if bf16 else ""
    k1 = f"conv3d64_fwd{sfx}"
    want_step = {**{k: 0 for k in all_counts()},
                 **{f"{k}{sfx}": n for k, n in GAN_STEP_LAUNCHES.items()}}
    state = {"t": 0.0, "counts": None, "steps": {}, "vis": {}}
    out = sys.stdout   # the CLI's own console log goes to `console` below
    name = f"CLI {dtype_name(bf16)}"

    def mark():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        state["t"], state["counts"] = time.perf_counter(), all_counts()

    def on_event(scale, event, it, info):
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t"]
        now = all_counts()
        delta = {k: now[k] - state["counts"][k] for k in now}
        peak = torch.cuda.max_memory_allocated(dev)
        values = {k: float(v) for k, v in info.items()}
        print(f"{name} scale {scale} {event} {it}: {wall:.4f} s, {values}, "
              f"peak memory {peak} bytes, launches "
              f"{ {k: v for k, v in delta.items() if v} }", file=out,
              flush=True)
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"{name} scale {scale} {event} {it}: a value is not finite")
        if delta["plain"]:
            fail(f"the plain versions ran {delta['plain']} times")
        if event == "step":
            state["steps"][scale] = state["steps"].get(scale, 0) + 1
            if scale == SCALE and delta != want_step:
                fail(f"a scale-{scale} GAN step of the {name} run launched "
                     f"{delta}, want {want_step}")
        elif event == "visualize":
            # 4 forwards through the scale's stages, 5 K1 convs a stage
            want = {**{k: 0 for k in delta}, k1: VIS_FORWARDS * 5 * scale}
            if delta != want:
                fail(f"--visualize at scale {scale} launched {delta}, want "
                     f"{want}")
            state["vis"][scale] = values
        mark()

    console = io.StringIO()   # kept out of the output's tail; logbook.txt
    flags = (["--video-path", str(ROOT / MAIN_CFG["video_path"]),
              "--niter", "2", "--pconv", "--pconv-all", "--pfuse",
              "--manualSeed", str(seed), "--run-dir", str(run_dir)]
             + (["--bf16"] if bf16 else []))
    with kept_logging():
        reset_counts()
        mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(console):
            cfg = train_video.main(flags + ["--visualize"],
                                   callback=on_event)
        print(f"{name} run with --visualize: {time.perf_counter() - t0:.3f} s "
              f"for {cfg.stop_scale + 1} scales, steps per scale "
              f"{state['steps']}", flush=True)
        vis9 = state["vis"].get(SCALE, {})
        print(f"{name} --visualize at scale {SCALE} ({VIS_FORWARDS} forwards "
              f"of batch {BATCH}, {VIS_IMAGES} image values): "
              f"{vis9.get('seconds', float('nan')):.4f} s, of which the "
              f"grids' encoding and writing on the host "
              f"{vis9.get('write_seconds', float('nan')):.4f} s", flush=True)
        exp = experiment_dir(run_dir)
        missing = [n for n in CLI_FILES if not (exp / n).exists()]
        with open(exp / "Noise_Amps.json") as f:
            amps = json.load(f)["noise_amps"]
        print(f"{name} files: {sorted(p.name for p in exp.iterdir())}; "
              f"amps {amps}", flush=True)
        if (missing or cfg.stop_scale != SCALE or len(amps) != SCALE + 1
                or amps[0] != 1.0 or not all(math.isfinite(a) for a in amps)
                or state["steps"] != {s: 2 for s in range(SCALE + 1)}
                or sorted(state["vis"]) != list(range(SCALE + 1))):
            fail(f"the {name} run is incomplete: missing {missing}, amps "
                 f"{amps}, steps {state['steps']}, visualized "
                 f"{sorted(state['vis'])}")
        check_events(exp, {s: 3 if s < MAIN_CFG["vae_levels"] else 5
                           for s in range(SCALE + 1)})
        if bf16:
            return all_counts()

        state["steps"] = {}
        mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(console):
            cfg = train_video.main(flags + ["--netG", str(exp / "netG")],
                                   callback=on_event)
    with open(exp.parent / "experiment_1" / "Noise_Amps.json") as f:
        amps2 = json.load(f)["noise_amps"]
    print(f"{name} resume from netG: {time.perf_counter() - t0:.3f} s, "
          f"steps per scale {state['steps']}, amps {amps2}", flush=True)
    if state["steps"] != {SCALE: 2} or len(amps2) != SCALE + 1:
        fail("the --netG resume did not retrain scale 9 alone with the amps "
             "kept")

    netG = str(exp / "netG")
    scfg = Config(netG=netG, pconv_all=True)
    apply_snapshot(scfg, netG, explicit=set(), user_chose_source=False)
    scfg.adjust_scales()
    session = SamplerSession(scfg, batch_size=BATCH, manual_seed=seed,
                             device=dev)
    before = all_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    sample = session.sample_batch()
    e1.record()
    e1.synchronize()
    now = all_counts()
    launched = {k: now[k] - before[k] for k in now}
    print(f"request from the CLI run: {e0.elapsed_time(e1):.3f} ms, shape "
          f"{sample.shape}, range [{sample.min():.4f}, {sample.max():.4f}], "
          f"launches { {k: v for k, v in launched.items() if v} }",
          flush=True)
    if sample.shape != (BATCH, *TOP_SHAPE[1:4], 3) or \
            not np.all(np.isfinite(sample)) or np.abs(sample).max() > 1.0:
        fail("the request from the CLI run is wrong")
    if launched != {**{k: 0 for k in launched}, "conv3d64_fwd": 5 * SCALE}:
        fail(f"the request from the CLI run launched {launched}")
    del session
    print(f"the CLI runs logged {console.getvalue().count(chr(10))} console "
          f"lines (as in their logbook.txt)", flush=True)
    torch.cuda.empty_cache()
    return all_counts()


# ---------------------------------------------------------------------------
# phase 6c: reproducible training; phases 11 and 12: GeneratorVAE_nb and
# the baselines through the CLIs
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Ends a CLI run from its callback (phase 6c's interrupted run)."""


# launches of one scale-9 step of the baselines under --pconv --pfuse
# (CSG/SG convs are VALID: no route; the SN critic runs apart on the real
# and the fake batch, two K2 pairs and one K1 block each, and once on the
# generator's fake, frozen)
BASELINE_STEP_LAUNCHES = {
    "conv3d64_fwd": 3,
    "conv3d64_pair": 6,
    # 5 a critic forward's backward (2 a pair + 1), three forwards
    "conv3d64_dx": 15,
    # 5 a critic forward of the critic step
    "conv3d64_dw": 10,
}
BASELINE_FILES = (["Z_init", "netG", "Noise_Amps", "Noise_Amps.json",
                   "config.json", "logbook.txt", "eval"]
                  + [f"netD_{s}" for s in range(SCALE + 1)])


def step_launches(per_step: dict, bf16: bool) -> dict:
    """Every counter: ``per_step`` of this dtype's kernels, 0 elsewhere."""
    sfx = "_bf16" if bf16 else ""
    return {**{k: 0 for k in all_counts()},
            **{f"{k}{sfx}": n for k, n in per_step.items()}}


def run_cli(main, flags, name: str, dev, want_step=None, stop=None):
    """One training CLI run in-process, its console kept out of the
    output: every calibration and step printed with its wall time, peak
    memory and launches; no plain call anywhere; each scale-9 step's
    launches equal to ``want_step`` (when given).  ``stop(scale, event,
    it)`` may raise ``_Stop`` to end the run.  Returns ``(cfg or None,
    steps per scale, scale-9 step seconds)``."""
    import torch
    from hpvaegan_tpu_torch.utils.logger import kept_logging

    state = {"t": 0.0, "counts": None, "steps": {}, "s9": []}
    out = sys.stdout

    def mark():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        state["t"], state["counts"] = time.perf_counter(), all_counts()

    def on_event(scale, event, it, info):
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t"]
        now = all_counts()
        delta = {k: now[k] - state["counts"][k] for k in now}
        peak = torch.cuda.max_memory_allocated(dev)
        values = {k: float(v) for k, v in info.items()}
        print(f"{name} scale {scale} {event} {it}: {wall:.4f} s, {values}, "
              f"peak memory {peak} bytes, launches "
              f"{ {k: v for k, v in delta.items() if v} }", file=out,
              flush=True)
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"{name} scale {scale} {event} {it}: a value is not finite")
        if delta["plain"]:
            fail(f"{name}: the plain versions ran {delta['plain']} times")
        if event == "step":
            state["steps"][scale] = state["steps"].get(scale, 0) + 1
            if scale == SCALE:
                state["s9"].append(wall)
                if want_step is not None and delta != want_step:
                    fail(f"a scale-{scale} step of the {name} run launched "
                         f"{delta}, want {want_step}")
        if stop is not None:
            stop(scale, event, it)
        mark()

    cfg = None
    with kept_logging(), contextlib.redirect_stdout(io.StringIO()):
        mark()
        try:
            cfg = main(flags, callback=on_event)
        except _Stop:
            pass
    return cfg, state["steps"], state["s9"]


def load_state(path: Path, key: str) -> dict:
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)[key]


def bit_equal(what: str, a: Path, b: Path) -> None:
    """``netG``'s weights or a ``netD_<s>``'s, bit for bit."""
    key = "gvars" if a.name.startswith("netG") else "dvars"
    sa, sb = load_state(a, key), load_state(b, key)
    import torch
    differ = [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
    if differ or set(sa) != set(sb):
        fail(f"{what}: {a} and {b} differ in {len(differ)} of {len(sa)} "
             f"tensors, first {differ[:4]}")
    print(f"{what}: {a.parent.parent.name}/{a.parent.name}/{a.name} and "
          f"{b.parent.parent.name}/{b.parent.name}/{b.name} bit-equal "
          f"({len(sa)} tensors)", flush=True)


# the scale phase 6c interrupts and resumes: the last whose T equals
# scale 0's.  The GAN steps draw their latent at the T of the first scale
# a process trains (the reference's Z_init_size quirk, kept by the JAX
# package, trainer.py:73-78), so a resume at scale 3-9 (T 5-13) draws
# other latents than the run it resumes, in either package
MID_SCALE = 2


def repro_main_path(dev, seed: int, runs: Path, bf16: bool):
    """Phase 6c: the CLI of phase 6 again on the same seed (no
    ``--visualize``, ``--save-interval 1``), its ``netG`` and ``netD_9``
    bit-equal to phase 6's run; then the same run stopped right after
    its ``netG_mid`` write at scale ``MID_SCALE`` and resumed from it,
    through the GAN scales to scale 9, ending bit-equal to the
    uninterrupted one.  Returns the launches of the three runs."""
    from hpvaegan_tpu_torch.cli import train_video
    dt = dtype_name(bf16)
    want = step_launches(GAN_STEP_LAUNCHES, bf16)
    first = experiment_dir(runs / dt)
    flags = (["--video-path", str(ROOT / MAIN_CFG["video_path"]),
              "--niter", "2", "--pconv", "--pconv-all", "--pfuse",
              "--manualSeed", str(seed), "--save-interval", "1"]
             + (["--bf16"] if bf16 else []))
    reset_counts()
    t0 = time.perf_counter()
    _, steps, s9 = run_cli(train_video.main, flags + [
        "--run-dir", str(runs / f"{dt}_again")], f"CLI {dt} again", dev,
        want)
    again = experiment_dir(runs / f"{dt}_again")
    print(f"CLI {dt} again: {time.perf_counter() - t0:.3f} s, steps "
          f"{steps}, scale-9 GAN steps {[round(s, 4) for s in s9]} s",
          flush=True)
    for name in ("netG", f"netD_{SCALE}"):
        bit_equal(f"two {dt} CLI runs of seed {seed}", first / name,
                  again / name)

    def stop(scale, event, it):
        if scale == MID_SCALE and event == "step" and it == 0:
            raise _Stop

    mid_dir = runs / f"{dt}_mid"
    run_cli(train_video.main, flags + ["--run-dir", str(mid_dir)],
            f"CLI {dt} interrupted", dev, want, stop=stop)
    mid = experiment_dir(mid_dir) / "netG_mid"
    import torch
    raw = torch.load(mid, map_location="cpu", weights_only=True)
    if (raw["scale"], raw["iteration"]) != (MID_SCALE, 1):
        fail(f"{mid}: scale {raw['scale']} iteration {raw['iteration']}")
    _, steps, s9 = run_cli(train_video.main, flags + [
        "--run-dir", str(mid_dir), "--netG", str(mid)],
        f"CLI {dt} resumed from netG_mid", dev, want)
    want_steps = {MID_SCALE: 1, **{s: 2 for s in range(MID_SCALE + 1,
                                                         SCALE + 1)}}
    if steps != want_steps:
        fail(f"the netG_mid resume ran steps {steps}, want {want_steps}")
    resumed = mid_dir / "wingsuit" / "DEBUG" / "experiment_1"
    for name in ("netG", f"netD_{SCALE}"):
        bit_equal(f"{dt} netG_mid resume against the uninterrupted run",
                  again / name, resumed / name)
    return all_counts()


def check_step_card_against_cpu(dev, seed: int, name: str, step: str,
                                bf16: bool) -> None:
    """One step of the full-width ``name`` model on a small pyramid, on
    the card and on the CPU path, from the same weights and draws: the
    metrics, BatchNorm statistics and spectral u/v agree at phase 5's
    bars.  ``step``: ``"vae"`` or ``"gan"`` (``GeneratorVAE_nb``), or
    ``"baseline"`` (``GeneratorCSG`` with the SN critic)."""
    import copy

    import numpy as np
    import torch
    from hpvaegan_tpu_torch.models.registry import make_discriminator
    from hpvaegan_tpu_torch.train import optim, steps

    base = name in ("GeneratorCSG", "GeneratorSG")
    cfg = main_config(img_size=48, min_size=24, max_size=48, bf16=bf16,
                      generator=name, pconv=True, pfuse=True,
                      pconv_all=not base)
    scale = 1 if step == "vae" else cfg.vae_levels
    cfg.scale_idx = scale
    pyr = cfg.pyramid()
    G = build_generator(cfg, scale, seed).requires_grad_(True)
    D = None
    if step != "vae":
        D = make_discriminator(cfg.discriminator, cfg, 3)
        D.reset_parameters(torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    real = np.tanh(draw(BATCH, *pyr.shape3d(scale), 3))
    real_zero = np.tanh(draw(BATCH, *pyr.shape3d(0), 3))
    amps = [1.0] + [cfg.noise_amp] * scale
    if base:
        z = draw(BATCH, *pyr.shape3d(0), 3)
        noise_init = draw(BATCH, *pyr.shape3d(0), 3)
        noises = [None] + [draw(*G._noise_shape(i, BATCH))
                           for i in range(1, len(G.body))]
    else:
        noise_init = draw(BATCH, *pyr.shape3d(0), cfg.latent_dim)
        noises = [draw(BATCH, *pyr.shape3d(i + 1), 3) for i in range(scale)]
        eps = (draw(BATCH, 1, 1, 1, cfg.latent_dim),
               rng.uniform(size=(BATCH, *pyr.shape3d(0), 1)).astype(
                   np.float32))
        latents = (draw(BATCH, 1, 1, 1, cfg.latent_dim),
                   rng.integers(0, 2, (BATCH, *pyr.shape3d(0), 1)).astype(
                       np.float32))
    runs = {}
    for where, g, d in (("cpu", G, D),
                        ("cuda", copy.deepcopy(G).to(dev),
                         None if D is None else copy.deepcopy(D).to(dev))):
        reset_counts()
        opt_g = optim.build_g_optimizer(cfg, g, scale)
        if step == "vae":
            metrics = steps.vae_step(g, opt_g, cfg, real, real_zero, amps,
                                     eps=eps)
        elif step == "gan":
            metrics = steps.gan_step(g, d, opt_g,
                                     optim.build_d_optimizer(cfg, d), cfg,
                                     real, real_zero, noise_init, amps,
                                     noises=noises, eps=eps, alpha=0.37,
                                     latents=latents)
        else:
            metrics = steps.baseline_step(g, d, opt_g,
                                          optim.build_d_optimizer(cfg, d),
                                          cfg, real, noise_init, z, amps,
                                          noises=noises, alphas=[0.37])
        bufs = {f"G.{k}": v.cpu().numpy() for k, v in g.named_buffers()}
        if d is not None:
            bufs.update({f"D.{k}": v.cpu().numpy()
                         for k, v in d.named_buffers()})
        runs[where] = ({k: float(v) for k, v in metrics.items()}, bufs)
        print(f"small-pyramid {name} {step} step on {where} "
              f"({dtype_name(bf16)}): {runs[where][0]}, launches "
              f"{ {k: v for k, v in all_counts().items() if v} }",
              flush=True)
    (m_cpu, b_cpu), (m_gpu, b_gpu) = runs["cpu"], runs["cuda"]
    worst = 0.0
    for key in list(m_cpu) + list(b_cpu):
        a = np.asarray(m_gpu[key] if key in m_gpu else b_gpu[key])
        b = np.asarray(m_cpu[key] if key in m_cpu else b_cpu[key])
        err = float(np.max(np.abs(a - b)))
        if bf16:
            ok = err <= BF16_MODEL_BAR * max(1.0, float(np.abs(b).max()))
        else:
            ok = np.allclose(a, b, rtol=RTOL, atol=ATOL)
        if not ok:
            fail(f"{name} {step} step on the card disagrees with the CPU "
                 f"path in {key}: {err:.3e}")
        worst = max(worst, err)
    print(f"card vs CPU {name} {step} step ({dtype_name(bf16)}) at scale "
          f"{scale} {pyr.shape3d(scale)}: metrics, BN statistics and u/v "
          f"agree, max_abs_err {worst:.3e}", flush=True)


def vae_nb_main_path(dev, seed: int, runs: Path, bf16: bool):
    """Phase 11: ``GeneratorVAE_nb`` at full width, the card against the
    CPU on one VAE and one GAN step, ``cli.train_video --generator
    GeneratorVAE_nb`` on the clip with ``--pconv --pconv-all --pfuse
    --niter 2`` (ten scales; a scale-9 GAN step launches what the main
    path's does), then ``cli.generate`` rand, rec and inject from level
    5 on the run.  Returns the launches of the CLI run and of generate."""
    from hpvaegan_tpu_torch.cli import train_video
    dt = dtype_name(bf16)
    for step in ("vae", "gan"):
        check_step_card_against_cpu(dev, seed, "GeneratorVAE_nb", step,
                                    bf16)
    run_dir = runs / f"vae_nb_{dt}"
    flags = (["--video-path", str(ROOT / MAIN_CFG["video_path"]),
              "--generator", "GeneratorVAE_nb", "--niter", "2", "--pconv",
              "--pconv-all", "--pfuse", "--manualSeed", str(seed),
              "--run-dir", str(run_dir)] + (["--bf16"] if bf16 else []))
    reset_counts()
    t0 = time.perf_counter()
    cfg, steps, s9 = run_cli(train_video.main, flags,
                             f"VAE_nb CLI {dt}", dev,
                             step_launches(GAN_STEP_LAUNCHES, bf16))
    exp = experiment_dir(run_dir)
    missing = [n for n in CLI_FILES if not (exp / n).exists()]
    print(f"VAE_nb CLI {dt}: {time.perf_counter() - t0:.3f} s for ten "
          f"scales, scale-9 GAN steps {[round(s, 4) for s in s9]} s, files "
          f"{sorted(p.name for p in exp.iterdir())}", flush=True)
    if missing or steps != {s: 2 for s in range(SCALE + 1)} or \
            cfg.generator != "GeneratorVAE_nb":
        fail(f"the VAE_nb {dt} run is incomplete: missing {missing}, "
             f"steps {steps}")
    launched = all_counts()
    gen = generate_main_path(dev, seed, exp, runs / f"vae_nb_gen_{dt}",
                             bf16)
    return {k: launched[k] + gen[k] for k in launched}


def generate_baseline(dev, seed: int, exp: Path, out_dir: Path, dt: str):
    """``cli.generate`` rand (4 samples) and rec (2, from the run's
    ``Z_init``) on a baselines run: the AVIs read back, no launch (the
    baselines' convs have no route); ``--inject-scale`` raises."""
    from hpvaegan_tpu_torch.cli import generate
    top_hw = TOP_SHAPE[2:4]
    reset_counts()
    for mode, n in (("rand", 4), ("rec", 2)):
        t0 = time.perf_counter()
        res = generate.main(["--netG", str(exp / "netG"), "--output-dir",
                             str(out_dir / mode), "--mode", mode,
                             "--num-samples", str(n), "--batch-size",
                             str(BATCH), "--manualSeed", str(seed),
                             "--metrics"])
        wall = time.perf_counter() - t0
        print(f"generate baselines {dt} {mode}: {wall:.3f} s in all, ms a "
              f"batch "
              f"{[round(t, 3) for t in res['batch_ms']]}, metrics "
              f"{res['metrics']}", flush=True)
        check_clips(f"generate baselines {mode}", res["paths"],
                    res["samples"], top_hw)
        if len(res["paths"]) != n:
            fail(f"generate baselines {mode} wrote {res['paths']}")
    try:
        generate.main(["--netG", str(exp / "netG"), "--inject-scale", "5"])
    except ValueError as e:
        print(f"generate baselines --inject-scale 5 raises: {e}", flush=True)
    else:
        fail("generate --inject-scale on a baseline did not raise")
    if any(all_counts().values()):
        fail(f"generate on a baseline launched {all_counts()}")


def baselines_main_path(dev, seed: int, runs: Path):
    """Phase 12: ``cli.train_video_baselines`` at full width on the clip:
    ``GeneratorCSG`` with the SN critic under ``--pconv --pfuse --niter
    2``, f32 and ``--bf16``, ten scales (the launches of a scale-9 step
    checked), the file set with ``Z_init``, in f32 a ``--netG`` resume
    that reloads ``Z_init`` and one card-against-CPU step on a small
    pyramid; ``cli.generate`` rand and rec on each run; then one f32
    ``GeneratorSG`` + ``WDiscriminatorBaselines`` run, which launches no
    kernel.  Returns the launches of the runs."""
    import torch
    from hpvaegan_tpu_torch.cli import train_video_baselines as tvb
    check_step_card_against_cpu(dev, seed, "GeneratorCSG", "baseline",
                                False)
    total = {k: 0 for k in all_counts()}

    def add():
        for k, v in all_counts().items():
            total[k] += v

    base = ["--video-path", str(ROOT / MAIN_CFG["video_path"]), "--niter",
            "2", "--manualSeed", str(seed)]
    for bf16 in (False, True):
        dt = dtype_name(bf16)
        run_dir = runs / f"csg_{dt}"
        flags = base + ["--pconv", "--pfuse", "--run-dir", str(run_dir)] + (
            ["--bf16"] if bf16 else [])
        reset_counts()
        t0 = time.perf_counter()
        cfg, steps, s9 = run_cli(tvb.main, flags, f"CSG CLI {dt}", dev,
                                 step_launches(BASELINE_STEP_LAUNCHES,
                                               bf16))
        add()
        exp = experiment_dir(run_dir)
        missing = [n for n in BASELINE_FILES if not (exp / n).exists()]
        with open(exp / "Noise_Amps.json") as f:
            amps = json.load(f)["noise_amps"]
        print(f"CSG CLI {dt}: {time.perf_counter() - t0:.3f} s for ten "
              f"scales, scale-9 steps {[round(s, 4) for s in s9]} s, amps "
              f"{amps}", flush=True)
        if (missing or steps != {s: 2 for s in range(SCALE + 1)}
                or len(amps) != SCALE + 1 or amps[0] != 1.0
                or not all(math.isfinite(a) for a in amps)):
            fail(f"the CSG {dt} run is incomplete: missing {missing}, "
                 f"steps {steps}, amps {amps}")
        if not bf16:
            reset_counts()
            _, steps, _ = run_cli(tvb.main, flags + ["--netG",
                                                     str(exp / "netG")],
                                  f"CSG CLI {dt} resumed", dev,
                                  step_launches(BASELINE_STEP_LAUNCHES,
                                                bf16))
            add()
            z0 = load_state(exp / "Z_init", "data")
            z1 = load_state(exp.parent / "experiment_1" / "Z_init", "data")
            if steps != {SCALE: 2} or not torch.equal(z0, z1):
                fail(f"the --netG resume ran {steps} and kept Z_init: "
                     f"{torch.equal(z0, z1)}")
            print(f"CSG --netG resume: scale {SCALE} retrained, Z_init "
                  f"reloaded bit-equal", flush=True)
        generate_baseline(dev, seed, exp, runs / f"csg_gen_{dt}", dt)
    run_dir = runs / "sg_f32"
    reset_counts()
    t0 = time.perf_counter()
    _, steps, s9 = run_cli(tvb.main, base + [
        "--generator", "GeneratorSG", "--discriminator",
        "WDiscriminatorBaselines", "--run-dir", str(run_dir)],
        "SG + WDiscriminatorBaselines CLI f32", dev,
        step_launches({}, False))
    print(f"SG + WDiscriminatorBaselines CLI f32: "
          f"{time.perf_counter() - t0:.3f} s for ten scales, scale-9 steps "
          f"{[round(s, 4) for s in s9]} s, no kernel launched (the "
          f"BatchNorm critic and the VALID stages have no route)",
          flush=True)
    if steps != {s: 2 for s in range(SCALE + 1)} or any(
            all_counts().values()):
        fail(f"the SG run: steps {steps}, launches {all_counts()}")
    generate_baseline(dev, seed, experiment_dir(run_dir), runs / "sg_gen",
                      "f32")
    return total


# ---------------------------------------------------------------------------
# phase 7: the sampling CLI; phase 7b: the server
# ---------------------------------------------------------------------------

def check_clips(what: str, paths, samples, hw) -> None:
    """The written AVIs: 13 frames of ``hw`` each, equal to the samples'
    de-normalisation; the samples finite and in [-1, 1]."""
    import numpy as np
    from hpvaegan_tpu_torch.utils.video_io import read_avi, to_uint8
    if not np.all(np.isfinite(samples)) or np.abs(samples).max() > 1.0:
        fail(f"{what}: samples not finite or outside [-1, 1]")
    for path, sample in zip(paths, samples):
        frames, _ = read_avi(path)
        if frames.shape != (TOP_SHAPE[1], *hw, 3) or \
                not np.array_equal(frames, to_uint8(sample)):
            fail(f"{what}: {path} holds {frames.shape}, want "
                 f"{(TOP_SHAPE[1], *hw, 3)} equal to its sample")


def generate_main_path(dev, seed: int, exp: Path, out_dir: Path,
                       bf16: bool = False):
    """``hpvaegan_tpu_torch.cli.generate`` in-process on the CLI run in
    ``exp`` (on the card, its default): rand with ``--metrics``, rec with
    ``--metrics``, ``--inject-scale 5`` and rand with ``--w-factor 1.5``
    (the clips at the top scale's T, H and the W it asks for).
    Returns the launches of the four calls."""
    from hpvaegan_tpu_torch.cli import generate

    k1 = "conv3d64_fwd_bf16" if bf16 else "conv3d64_fwd"
    top_hw = TOP_SHAPE[2:4]
    cases = [  # name, flags, batches, K1 launches a batch, (H, W)
        ("rand", ["--num-samples", "4", "--metrics"], 2, 5 * SCALE, top_hw),
        ("rec", ["--mode", "rec", "--num-samples", "2", "--metrics"], 1,
         5 * SCALE, top_hw),
        (f"inject {INJECT_SCALE}", ["--inject-scale", str(INJECT_SCALE),
                                    "--num-samples", "2"], 1,
         5 * (SCALE - INJECT_SCALE), top_hw),
        # two batches: the first at a new shape pays the first-call costs
        ("rand w x1.5", ["--w-factor", "1.5", "--num-samples", "4"], 2,
         5 * SCALE, (top_hw[0], round(top_hw[1] * 1.5)))]
    reset_counts()
    for i, (name, extra, batches, per_batch, hw) in enumerate(cases):
        before = all_counts()
        t0 = time.perf_counter()
        res = generate.main(["--netG", str(exp / "netG"), "--output-dir",
                             str(out_dir / f"{dtype_name(bf16)}_{i}"),
                             "--batch-size", str(BATCH), "--manualSeed",
                             str(seed), *extra])
        wall = time.perf_counter() - t0
        now = all_counts()
        launched = {k: now[k] - before[k] for k in now}
        print(f"generate {dtype_name(bf16)} {name}: {wall:.3f} s in all, "
              f"ms a batch {[round(t, 3) for t in res['batch_ms']]}, AVI "
              f"write ms a clip {[round(t, 3) for t in res['write_ms']]}, "
              f"metrics {res['metrics']}, launches "
              f"{ {k: v for k, v in launched.items() if v} }", flush=True)
        want = {**{k: 0 for k in launched}, k1: batches * per_batch}
        if launched != want or len(res["batch_ms"]) != batches:
            fail(f"generate {name} launched {launched} in "
                 f"{len(res['batch_ms'])} batches, want {want} in {batches}")
        n = int(extra[extra.index("--num-samples") + 1])
        if len(res["paths"]) != n:
            fail(f"generate {name} wrote {res['paths']}")
        check_clips(f"generate {name}", res["paths"], res["samples"], hw)
        metric = list(res["metrics"].values())
        if "--metrics" in extra and not (metric and math.isfinite(metric[0])):
            fail(f"generate {name}: metrics {res['metrics']}")
    return all_counts()


def serve_cli_main_path(dev, seed: int, exp: Path, out_dir: Path):
    """``hpvaegan_tpu_torch.cli.serve`` in-process on the f32 CLI run, on
    the card with ``--coalesce-ms 30``: stdio requests on in-memory
    streams, four concurrent unseeded requests through the coalescer,
    HTTP on a free port (health, two requests).  Returns the launches of
    the server's life."""
    import threading
    import urllib.request

    from hpvaegan_tpu_torch.cli import serve

    per_batch = 5 * SCALE
    reset_counts()
    server, _ = serve.make_server(["--netG", str(exp / "netG"),
                                   "--output-dir", str(out_dir),
                                   "--coalesce-ms", "30", "--manualSeed",
                                   str(seed)])
    try:
        warm = all_counts()
        if warm["conv3d64_fwd"] != per_batch or warm["plain"]:
            fail(f"the server's warmup launched {warm}")
        reqs = [{"id": "write", "num_samples": 2, "seed": 1},
                {"id": "nowrite", "num_samples": 2, "seed": 2,
                 "write": False},
                {"id": "same_a", "num_samples": 2, "seed": 7},
                {"id": "same_b", "num_samples": 2, "seed": 7},
                {"id": "rec", "mode": "rec", "num_samples": 2}]
        stream = io.StringIO()
        serve.serve_stdio(server, io.StringIO(
            "".join(json.dumps(r) + "\n" for r in reqs)), stream)
        lines = [json.loads(x) for x in stream.getvalue().splitlines()]
        resps = lines[1:]
        launched = all_counts()["conv3d64_fwd"] - warm["conv3d64_fwd"]
        for r in resps:
            print(f"serve stdio {r.get('id')}: ok {r['ok']}, device_ms "
                  f"{r.get('device_ms')}, latency_ms {r.get('latency_ms')}, "
                  f"files {len(r.get('paths', []))}", flush=True)
        if len(resps) != len(reqs) or not all(r["ok"] for r in resps):
            fail(f"serve stdio: {resps}")
        if launched != per_batch * len(reqs):
            fail(f"serve stdio launched {launched} K1, want "
                 f"{per_batch * len(reqs)} ({per_batch} a dispatch)")
        with open(resps[2]["paths"][0], "rb") as a, \
                open(resps[3]["paths"][0], "rb") as b:
            if a.read() != b.read():
                fail("the same seeded request wrote different files")
        if resps[1]["paths"] or resps[1]["sample_shape"] != [
                *TOP_SHAPE[1:4], 3]:
            fail(f"the write: false request answered {resps[1]}")

        before = all_counts()["conv3d64_fwd"]
        dispatches = server.coalescer.dispatches
        out = [None] * 4

        def go(i):
            out[i] = server.handle({"id": f"co{i}", "num_samples": 1})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        dispatches = server.coalescer.dispatches - dispatches
        launched = all_counts()["conv3d64_fwd"] - before
        for r in out:
            print(f"serve coalesced {r and r.get('id')}: ok {r and r['ok']}, "
                  f"device_ms {r and r.get('device_ms')}, latency_ms "
                  f"{r and r.get('latency_ms')}", flush=True)
        print(f"serve coalesced: 4 one-sample requests in {dispatches} "
              f"dispatches, {launched} K1 launches ({per_batch} a dispatch)",
              flush=True)
        if not all(r is not None and r["ok"] for r in out) or \
                not 1 <= dispatches <= 2 or launched != per_batch * dispatches:
            fail(f"the coalesced requests: {out}, {dispatches} dispatches, "
                 f"{launched} launches")
        if len({open(r["paths"][0], "rb").read() for r in out}) != 4:
            fail("the coalesced requests' samples are not distinct")

        from hpvaegan_tpu_torch.cli.serve import serve_http
        box, started = {}, threading.Event()

        def ready(httpd):
            box["httpd"] = httpd
            started.set()

        before = all_counts()["conv3d64_fwd"]
        thread = threading.Thread(target=serve_http,
                                  args=(server, "127.0.0.1", 0, ready),
                                  daemon=True)
        thread.start()
        if not started.wait(60):
            fail("the HTTP server did not start")
        url = f"http://127.0.0.1:{box['httpd'].server_address[1]}"
        try:
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            http = []   # two requests: each in a new handler thread
            for i in range(2):
                req = urllib.request.Request(
                    f"{url}/generate", headers={"Content-Type":
                                                "application/json"},
                    data=json.dumps({"id": f"http{i}", "num_samples": 2,
                                     "seed": 3 + i}).encode())
                with urllib.request.urlopen(req, timeout=120) as r:
                    http.append(json.loads(r.read()))
        finally:
            box["httpd"].shutdown()
            thread.join(timeout=60)
        launched = all_counts()["conv3d64_fwd"] - before
        print(f"serve HTTP: healthz {health}; generate "
              + "; ".join(f"{r.get('id')} ok {r['ok']}, device_ms "
                          f"{r.get('device_ms')}, latency_ms "
                          f"{r.get('latency_ms')}" for r in http)
              + f"; {launched} K1 launches", flush=True)
        if not health.get("ok") or not all(r["ok"] for r in http) or \
                launched != 2 * per_batch:
            fail(f"serve HTTP: {health}, {http}, {launched} launches")
        # each HTTP request comes in a new handler thread, its batches run
        # on the server's one device thread: no first-call cost of a new
        # thread, so its device_ms is a stdio request's of the same size
        stdio_ms = max(r["device_ms"] for r in resps[:4])
        http_ms = min(r["device_ms"] for r in http)
        print(f"serve HTTP against stdio, device_ms of 2 seeded clips: "
              f"HTTP {http_ms} (the least of 2), stdio {stdio_ms} (the "
              f"most of 4), bar 1.2x", flush=True)
        if http_ms > 1.2 * stdio_ms:
            fail(f"an HTTP request's device_ms {http_ms} is above 1.2x a "
                 f"stdio request's {stdio_ms}")
    finally:
        server.close()
    counts = all_counts()
    if counts["plain"] or any(v for k, v in counts.items()
                              if k not in ("conv3d64_fwd", "plain")):
        fail(f"the server launched {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 9: evaluation on the card; phase 10: the 2D image path
# ---------------------------------------------------------------------------

EVAL_LAYER, EVAL_SAMPLES = "conv3b", 4
# the card's C3D statistics against the CPU's on the same clip: max |card -
# CPU| <= STATS_TOL * max |CPU| over mu and over cov (f32 features, cuDNN
# and the CPU's convs summing in other orders; float64 moments), and
# SVFID within SVFID_TOL of the CPU's, relative
STATS_TOL, SVFID_TOL = 1e-4, 1e-3
IMAGE_NAME = "wingsuit_frame0"
IMAGE_TOP = (144, 256)
IMAGE_INJECT = 5
IMAGE_FILES = (["netG", "Noise_Amps", "Noise_Amps.json", "config.json",
                "logbook.txt", "eval"]
               + [f"netD_{s}" for s in range(MAIN_CFG["vae_levels"],
                                             SCALE + 1)])
# --visualize of the 2D trainer: five grids, one image value each
IMAGE_VIS_IMAGES = 5


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    import numpy as np
    return float(np.max(np.abs(np.asarray(got) - ref))
                 / max(float(np.max(np.abs(ref))), 1e-30))


@contextlib.contextmanager
def logged_lines():
    """The messages logged at INFO and above inside the block."""
    import logging

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lines, root, handler = [], logging.getLogger(), Keep(logging.INFO)
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def eval_main_path(dev, seed: int, runs: Path):
    """Phase 9: SVFID at ``conv3b`` of four rand samples of each of
    phase 6's runs (f32 and bf16) against the real top-scale clip (13 x
    144 x 256), through ``cli.generate --svfid`` (the trunk built afresh
    in each call) and through ``svfid(...)`` on the same samples; every
    score finite and > 0, the real clip against itself below 1e-3 of the
    smallest; the card's C3D statistics of the real clip and the SVFID
    of one sample against the CPU's.  Returns the launches of the two
    generate calls (the sampler's K1; C3D runs cuDNN)."""
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.cli import generate
    from hpvaegan_tpu_torch.eval import _svfid, svfid
    from hpvaegan_tpu_torch.eval.c3d import random_c3d_params

    reset_counts()
    real, scored = None, {}
    for bf16 in (False, True):
        name = f"eval {dtype_name(bf16)}"
        k1 = "conv3d64_fwd_bf16" if bf16 else "conv3d64_fwd"
        argv = ["--netG", str(experiment_dir(runs / dtype_name(bf16))
                              / "netG"),
                "--output-dir", str(runs / "eval" / dtype_name(bf16)),
                "--batch-size", str(BATCH), "--manualSeed", str(seed),
                "--num-samples", str(EVAL_SAMPLES), "--svfid"]
        _svfid._trunk.cache_clear()   # each call builds its trunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = all_counts()
        t0 = time.perf_counter()
        with logged_lines() as lines:
            res = generate.main(argv)
        wall = time.perf_counter() - t0
        now = all_counts()
        launched = {k: now[k] - before[k] for k in now}
        scores = res["metrics"]["svfid"]["per_sample"]
        eval_ms = res["eval_ms"]["svfid"]
        said = [x for x in lines if x.startswith(
            f"SVFID[{EVAL_LAYER}] (RANDOM C3D — relative only): mean")]
        print(f"{name}: generate --svfid {wall:.3f} s in all, ms a batch "
              f"{[round(t, 3) for t in res['batch_ms']]}; SVFID "
              f"{eval_ms:.3f} ms for {len(scores)} samples, "
              f"{eval_ms / max(len(scores), 1):.3f} ms a scored sample with "
              f"the trunk's build; per sample {scores}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev)} bytes; log {said}",
              flush=True)
        want = {**{k: 0 for k in launched}, k1: 2 * 5 * SCALE}
        if launched != want:
            fail(f"{name} launched {launched}, want {want}")
        if (len(scores) != EVAL_SAMPLES or len(said) != 1
                or not all(math.isfinite(s) and s > 0 for s in scores)):
            fail(f"{name}: scores {scores}, log lines {said}")
        if real is None:
            sess = generate.open_session(generate.build_parser().parse_args(
                argv), generate.build_parser, argv)
            real = sess.real_clip(SCALE)
            del sess
            if real.shape != (*TOP_SHAPE[1:4], 3):
                fail(f"the real clip has shape {real.shape}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = svfid(real, list(res["samples"]), feature_layer=EVAL_LAYER,
                       device=dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        print(f"{name}: svfid(...) on the same samples, trunk built: "
              f"{warm_ms:.3f} ms, {warm_ms / EVAL_SAMPLES:.3f} ms a scored "
              f"sample; per sample {direct['per_sample']}", flush=True)
        if not np.allclose(direct["per_sample"], scores, rtol=1e-6, atol=0):
            fail(f"{name}: svfid(...) gives {direct['per_sample']}, the CLI "
                 f"{scores}")
        scored[bf16] = (res["samples"], scores)
    launches = all_counts()

    self_score = svfid(real, [real], device=dev)["per_sample"][0]
    smallest = min(min(s) for _, s in scored.values())
    print(f"eval: SVFID of the real clip against itself {self_score:.6e}, "
          f"the smallest sample score {smallest:.4f}", flush=True)
    if not abs(self_score) < 1e-3 * smallest:
        fail(f"SVFID(real, real) = {self_score}, not below 1e-3 of "
             f"{smallest}")

    # the card against the CPU on the real clip and one f32 sample
    trunk = _svfid._trunk(EVAL_LAYER, 0, "", _svfid._device_key(dev))
    params = random_c3d_params(EVAL_LAYER, 0)
    fake = scored[False][0][0]
    stats = {}
    for where, model in (("card", trunk), ("cpu", params)):
        t0 = time.perf_counter()
        stats[where] = [_svfid.c3d_feature_stats(model, x, EVAL_LAYER,
                                                 device="cpu")
                        for x in (real, fake)]
        print(f"eval: C3D statistics of two clips on the {where}: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    (mu_c, cov_c), (mu_fc, cov_fc) = stats["card"]
    (mu_h, cov_h), (mu_fh, cov_fh) = stats["cpu"]
    err_mu, err_cov = rel_err(mu_c, mu_h), rel_err(cov_c, cov_h)
    s_card = _svfid.frechet_distance(mu_c, cov_c, mu_fc, cov_fc)
    s_cpu = _svfid.frechet_distance(mu_h, cov_h, mu_fh, cov_fh)
    err_s = abs(s_card - s_cpu) / abs(s_cpu)
    print(f"eval: card vs CPU on the real clip: mu {err_mu:.3e}, cov "
          f"{err_cov:.3e} (of the max, bar {STATS_TOL}); SVFID of sample 0 "
          f"card {s_card:.6f}, CPU {s_cpu:.6f}, relative {err_s:.3e} (bar "
          f"{SVFID_TOL}); the CLI said {scored[False][1][0]:.6f}", flush=True)
    if err_mu > STATS_TOL or err_cov > STATS_TOL or err_s > SVFID_TOL:
        fail("the card's C3D statistics disagree with the CPU's")
    torch.cuda.empty_cache()
    return launches


def image_config(**over):
    from hpvaegan_tpu_torch.core.config import Config
    cfg = Config(**{**MAIN_CFG, "video_path": "", "pconv_all": False,
                    "image_path": f"{IMAGE_NAME}.png", **over})
    cfg.ar = CLIP_AR
    cfg.adjust_scales()
    return cfg


def check_image_card_against_cpu(dev, seed: int) -> None:
    """The 2D generator at full widths on a small pyramid, on the card
    (cuDNN) and on the CPU, on the same weights and draws: the tests'
    f32 bar.  No kernel runs."""
    import copy

    import numpy as np
    import torch
    from hpvaegan_tpu_torch.models.registry import make_generator

    cfg = image_config(img_size=48, min_size=24, max_size=48)
    scale, pyr = cfg.stop_scale, cfg.pyramid2d()
    gen = torch.Generator().manual_seed(seed)
    G = make_generator(cfg.generator, cfg, pyr, ndim=2)
    G.init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((BATCH, *pyr.shape2d(0), cfg.latent_dim),
                            dtype=np.float32)
    noises = [rng.standard_normal((BATCH, *pyr.shape2d(i + 1), 3),
                                  dtype=np.float32) for i in range(scale)]
    amps = [1.0] + [cfg.noise_amp] * scale
    outs = {}
    reset_counts()
    for name, model in (("cpu", G), ("cuda", copy.deepcopy(G).to(dev))):
        with torch.inference_mode():
            out, _, _ = model.apply(amps, noise_init=z, mode="rand",
                                    train=True, noises=noises)
            outs[name] = out.float().cpu().numpy()
    err = float(np.max(np.abs(outs["cuda"] - outs["cpu"])))
    print(f"2D card vs CPU path (f32), {pyr.shape2d(scale)} at scale "
          f"{scale}: max_abs_err {err:.3e}; launches {all_counts()}",
          flush=True)
    if not np.allclose(outs["cuda"], outs["cpu"], rtol=RTOL, atol=ATOL):
        fail(f"the 2D generator on the card disagrees with the CPU path "
             f"(max_abs_err {err:.3e})")


def image_main_path(dev, seed: int, work: Path):
    """Phase 10: frame 0 of the clip's frames file as a PNG (the port's
    writer), ``cli.train_image`` on it at the default geometry (ten
    scales, 18 x 33 to 144 x 256, nfc 64, latent 128, 5 layers) with
    ``--niter 2 --visualize``, in f32 and under ``--bf16``, then
    ``cli.generate --image-path ... --sifid --metrics`` in rand and rec
    modes and at ``--inject-scale 5``: the file set, ten amps, the event
    file, each PNG read back equal to its sample, the SIFID line.  The
    2D models hold no kernel: returns the launches, all zero."""
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.cli import generate, train_image
    from hpvaegan_tpu_torch.utils.logger import kept_logging
    from hpvaegan_tpu_torch.utils.png import encode_png, read_png

    with np.load(ROOT / "data" / "vids" / "wingsuit.frames.npz") as data:
        frame = np.asarray(data["frames"][0], np.uint8)
    image = work / f"{IMAGE_NAME}.png"
    image.write_bytes(encode_png(frame))
    if frame.shape != (*TOP_SHAPE[2:4], 3) or not np.array_equal(
            read_png(str(image)), frame):
        fail(f"the frame PNG does not read back ({frame.shape})")
    check_image_card_against_cpu(dev, seed)

    reset_counts()
    console = io.StringIO()
    for bf16 in (False, True):
        name = f"image CLI {dtype_name(bf16)}"
        run_dir = work / dtype_name(bf16)
        state = {"t": 0.0, "scale": {}, "steps": {}}

        def mark():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            state["t"] = time.perf_counter()

        def on_event(scale, event, it, info):
            torch.cuda.synchronize()
            s = state["scale"].setdefault(scale, [0.0, 0])
            s[0] += time.perf_counter() - state["t"]
            s[1] = max(s[1], torch.cuda.max_memory_allocated(dev))
            if event == "step":
                state["steps"][scale] = state["steps"].get(scale, 0) + 1
            if not all(math.isfinite(float(v)) for v in info.values()):
                fail(f"{name} scale {scale} {event} {it}: {info}")
            mark()

        flags = (["--image-path", str(image), "--niter", "2",
                  "--manualSeed", str(seed), "--run-dir", str(run_dir),
                  "--visualize"] + (["--bf16"] if bf16 else []))
        with kept_logging():
            mark()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(console):
                cfg = train_image.main(flags, callback=on_event)
            wall = time.perf_counter() - t0
        for scale, (secs, peak) in sorted(state["scale"].items()):
            print(f"{name} scale {scale} {cfg.pyramid2d().shape2d(scale)}: "
                  f"{secs:.4f} s (calibration, 2 steps, --visualize), peak "
                  f"memory {peak} bytes", flush=True)
        exp = Path(run_dir) / IMAGE_NAME / "DEBUG" / "experiment_0"
        missing = [n for n in IMAGE_FILES if not (exp / n).exists()]
        with open(exp / "Noise_Amps.json") as f:
            amps = json.load(f)["noise_amps"]
        print(f"{name}: {wall:.3f} s for {cfg.stop_scale + 1} scales; files "
              f"{sorted(p.name for p in exp.iterdir())}; amps {amps}",
              flush=True)
        if (missing or cfg.stop_scale != SCALE or len(amps) != SCALE + 1
                or amps[0] != 1.0 or not all(math.isfinite(a) for a in amps)
                or cfg.pyramid2d().shape2d(SCALE) != IMAGE_TOP
                or state["steps"] != {s: 2 for s in range(SCALE + 1)}):
            fail(f"the {name} run is incomplete: missing {missing}, amps "
                 f"{amps}, steps {state['steps']}")
        check_events(exp, {s: 3 if s < MAIN_CFG["vae_levels"] else 5
                           for s in range(SCALE + 1)},
                     n_images=IMAGE_VIS_IMAGES)

        for mode, extra in (("rand", []), ("rec", ["--mode", "rec"]),
                            (f"inject {IMAGE_INJECT}",
                             ["--inject-scale", str(IMAGE_INJECT)])):
            out_dir = work / "generate" / f"{dtype_name(bf16)}_{mode[:6]}"
            t0 = time.perf_counter()
            with logged_lines() as lines:
                res = generate.main(
                    ["--netG", str(exp / "netG"), "--image-path",
                     str(image), "--output-dir", str(out_dir),
                     "--batch-size", str(BATCH), "--manualSeed", str(seed),
                     "--num-samples", "4", "--sifid", "--metrics", *extra])
            wall = time.perf_counter() - t0
            said = [x for x in lines if x.startswith(
                "SIFID[pool1] (RANDOM stem — relative only): mean")]
            samples = res["samples"]
            metrics = {k: v for k, v in res["metrics"].items()
                       if k != "sifid"}
            print(f"image generate {dtype_name(bf16)} {mode}: {wall:.3f} s "
                  f"in all, ms a batch "
                  f"{[round(t, 3) for t in res['batch_ms']]}, PNG write ms "
                  f"{[round(t, 3) for t in res['write_ms']]}, SIFID "
                  f"{res['eval_ms']['sifid']:.3f} ms, metrics {metrics}, "
                  f"log {said}", flush=True)
            stem = "inject" if mode.startswith("inject") else "sample"
            if (len(res["paths"]) != 4 or len(said) != 1
                    or samples.shape != (4, *IMAGE_TOP, 3)
                    or not np.all(np.isfinite(samples))
                    or np.abs(samples).max() > 1.0
                    or sorted(p.name for p in out_dir.iterdir())
                    != [f"{stem}_{i}.png" for i in range(4)]):
                fail(f"image generate {mode}: {res['paths']}, "
                     f"{samples.shape}, log {said}")
            for path, s in zip(res["paths"], samples):
                want = np.uint8((np.clip(s, -1, 1) + 1.0) * 127.5)
                if not np.array_equal(read_png(path), want):
                    fail(f"{path} does not hold its sample")
            sifid = res["metrics"]["sifid"]["per_sample"]
            if not all(math.isfinite(v) and v > 0 for v in sifid):
                fail(f"image generate {mode}: SIFID {sifid}")
    print(f"the image runs logged {console.getvalue().count(chr(10))} "
          f"console lines", flush=True)
    launched = all_counts()
    if any(launched.values()):
        fail(f"the 2D path launched {launched}: its convs are stock")
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# phase 8: the sharded path, ranks sharing the card over gloo
# ---------------------------------------------------------------------------

SHARDED_MESHES = {2: (1, 2), 4: (2, 2)}     # world -> K4's meshes
CLI_MESH = "1x2"                            # the sharded CLI's mesh
RANK_TIMEOUT_S = 900
K4_ITERS = 5
# launches of one scale-9 GAN step under --spmd --pconv --pconv-all on a
# rank: --pfuse is off under --spmd, so the critic body's five convs run
# K1 through K4 (GAN_STEP_LAUNCHES with K2's pairs as single convs)
SHARDED_STEP_LAUNCHES = {"conv3d64_fwd": 145, "conv3d64_pair": 0,
                         "conv3d64_dx": 80, "conv3d64_dw": 75,
                         "conv3d64_spmd": 145}
SHARDED = "ranks sharing one card over gloo"


def sharded_label() -> str:
    """How phase 8's figures were taken, with the card's name and power
    limit."""
    return f"{SHARDED}: {card_line()}"


def sharded_flags(seed: int, bf16: bool) -> list:
    """The flags of phase 8b's runs, less the mesh's and the run dir."""
    return (["--video-path", str(ROOT / MAIN_CFG["video_path"]), "--niter",
             "2", "--pconv", "--pconv-all", "--manualSeed", str(seed)]
            + (["--bf16"] if bf16 else []))


def spmd_counts() -> dict:
    """all_counts() with K4's compositions (f32 and bf16)."""
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    c = all_counts()
    c.update(conv3d64_spmd=k4.counts.launches,
             conv3d64_spmd_bf16=k4.counts.bf16_launches)
    c["plain"] += k4.counts.plain_calls
    return c


def run_ranks(world: int, argv, label: str):
    """``world`` ranks of this script (``argv`` after ``--rank``) through
    the launcher's environment (HPVAEGAN_*), all on this card; their
    output is printed by rank once they end.  Any rank's failure, or a
    group that outlives RANK_TIMEOUT_S, stops the others and fails the
    run."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        files = [open(Path(logs) / f"rank{r}.log", "w+") for r in
                 range(world)]
        try:
            for rank in range(world):
                env = dict(os.environ, HPVAEGAN_COORDINATOR=coordinator,
                           HPVAEGAN_NUM_PROCESSES=str(world),
                           HPVAEGAN_PROCESS_ID=str(rank))
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--rank", *argv], cwd=str(ROOT), env=env,
                    stdout=files[rank], stderr=subprocess.STDOUT))
            failed = None
            while failed is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                elif all(c == 0 for c in codes):
                    break
                elif time.perf_counter() - t0 > RANK_TIMEOUT_S:
                    failed = f"the ranks outlived {RANK_TIMEOUT_S} s"
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for rank, f in enumerate(files):
                f.seek(0)
                for line in f.read().splitlines():
                    if not line.startswith(("Training scale", "Scale [")):
                        print(f"[{label} rank {rank}] {line}", flush=True)
                f.close()
    if failed:
        fail(f"{label}: {failed}")
    print(f"{label}: {world} ranks done in {time.perf_counter() - t0:.3f} s",
          flush=True)


def _concurrent_ms(fn, iters: int) -> float:
    """Host-clock ms a call of ``fn``, every rank of the group calling it
    at the same time (a barrier before), the card synchronised."""
    import torch
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _alone_ms(fn, iters: int) -> float:
    """``time_ms`` of ``fn`` on this rank while the others wait at a
    barrier (one rank at a time on the card)."""
    import torch.distributed as dist
    out = None
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn == dist.get_rank():
            out = time_ms(fn, iters)
    dist.barrier()
    return out


def rank_k4(out: Path, seed: int) -> None:
    """One rank of phase 8a: K4 at the critic's shape on this rank's mesh
    (1x2 with two ranks, 2x2 with four), f32 and bf16, held against K1 on
    the whole volume (every rank runs it itself) and against the plain
    composition; its timings; a JSON result in ``out``."""
    import torch
    import torch.nn.functional as F
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    from hpvaegan_tpu_torch.parallel import make_mesh, maybe_initialize
    from hpvaegan_tpu_torch.parallel.distributed import all_reduce_, backend
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = maybe_initialize(True, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(SHARDED_MESHES[world])
    H = CRITIC_SHAPE[2]
    h0, h1 = mesh.block(H)
    b0, b1 = mesh.batch_rows(CRITIC_SHAPE[0])
    halo_shape = (b1 - b0, CRITIC_SHAPE[1], h1 - h0 + 2, *CRITIC_SHAPE[3:])
    label = sharded_label()
    print(f"mesh {mesh.shape} position {(mesh.data_index, mesh.spatial_index)}"
          f", backend {backend()} on {dev} ({label}), rows [{h0}, {h1}) "
          f"of {H}, batch rows [{b0}, {b1}), haloed block {halo_shape}",
          flush=True)
    result = {"rank": rank, "mesh": list(mesh.shape), "backend": backend(),
              "halo_shape": list(halo_shape)}
    for bf16 in (False, True):
        name = dtype_name(bf16)
        g = torch.Generator(device=dev).manual_seed(seed)
        x, w, b = conv_inputs(dev, g, CRITIC_SHAPE)
        dy = torch.randn(CRITIC_SHAPE, device=dev, generator=g)
        if bf16:
            x, dy = x.bfloat16(), dy.bfloat16()
        # single-process K1 on the whole volume
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y_ref = cp.conv3d64(xr, wr, br)
        y_ref.backward(dy)
        # K4 on this rank's block, then the plain composition
        got = {}
        for fn in (k4.conv3d64_spmd, k4.conv3d64_spmd_plain):
            xl = mesh.shard(x, 2).requires_grad_(True)
            wl, bl = (t.clone().requires_grad_(True) for t in (w, b))
            y = fn(xl, wl, bl, mesh)
            y.backward(mesh.shard(dy, 2))
            got[fn.__name__] = (y.detach(), xl.grad,
                                all_reduce_(wl.grad.clone()),
                                all_reduce_(bl.grad.clone()))
        y, dx, dw, db = got["conv3d64_spmd"]
        # bf16: y rounds once (1 ulp); dx's edge rows add the neighbours'
        # halo cotangents in bf16 after the kernel's rounding (2 ulp); dw
        # and db are f32 sums of the same products, but the plain
        # composition's autograd rounds them to bf16 through its cast of
        # w and b (1 ulp)
        tol_y = tol_wb = BF16_TOL if bf16 else KERNEL_TOL
        tol_dx = BF16_TOL2 if bf16 else KERNEL_TOL
        errs = [check_close(f"K4 {name} {mesh.shape} rank {rank} y vs K1 "
                            f"on the whole volume", y,
                            mesh.shard(y_ref.detach(), 2), tol_y),
                check_close(f"K4 {name} {mesh.shape} rank {rank} dx vs K1",
                            dx, mesh.shard(xr.grad, 2), tol_dx),
                check_close(f"K4 {name} {mesh.shape} rank {rank} dw (summed "
                            f"over the ranks) vs K1", dw, wr.grad),
                check_close(f"K4 {name} {mesh.shape} rank {rank} db vs K1",
                            db, br.grad)]
        # K4 against its plain version: the kernels row's max_abs_err is
        # y's, as every other row's is its output's
        plain_errs = [check_close(
            f"K4 {name} {mesh.shape} rank {rank} {what} vs the plain "
            f"composition", got["conv3d64_spmd"][i],
            got["conv3d64_spmd_plain"][i], tol)
            for i, (what, tol) in enumerate((("y", tol_y), ("dx", tol_dx),
                                             ("dw", tol_wb),
                                             ("db", tol_wb)))]
        del xr, wr, br, y_ref, got, y, dx, dw, db
        torch.cuda.empty_cache()

        with torch.no_grad():
            xl = mesh.shard(x, 2)
            z = k4.halo(xl, mesh, 2)
            zc = ncdhw(z)
            wc, bc = oi(w).to(x.dtype), b.to(x.dtype)
            row = {
                "max_abs_err": plain_errs[0],
                "max_abs_err_vs_whole_k1": errs,
                "k4_ms": _concurrent_ms(
                    lambda: k4.conv3d64_spmd(xl, w, b, mesh), K4_ITERS),
                "plain_ms": _concurrent_ms(
                    lambda: k4.conv3d64_spmd_plain(xl, w, b, mesh), 2),
                "exchange_ms": _concurrent_ms(
                    lambda: k4.halo(xl, mesh, 2), K4_ITERS),
                "library_ms": _concurrent_ms(
                    lambda: F.conv3d(zc, wc, bc, padding=1), K4_ITERS),
                "k1_alone_ms": _alone_ms(lambda: cp.conv3d64(z, w, b),
                                         K4_ITERS),
                "library_alone_ms": _alone_ms(
                    lambda: F.conv3d(zc, wc, bc, padding=1), K4_ITERS),
            }
        row["bound_ms"], row["bound_by"] = k1_bound(halo_shape, bf16=bf16)
        print(f"K4 {name} {mesh.shape} rank {rank} ({label}): the K4 call "
              f"{row['k4_ms']:.4f} ms (exchange {row['exchange_ms']:.4f}), "
              f"the plain composition {row['plain_ms']:.4f}, F.conv3d on "
              f"the haloed block {row['library_ms']:.4f}, all ranks at once;"
              f" alone: K1 on the haloed block {row['k1_alone_ms']:.4f} ms "
              f"against its bound {row['bound_ms']:.4f} (k1_bound x "
              f"{halo_shape[0] * halo_shape[2]}/{CRITIC_SHAPE[0] * H} of the "
              f"volume), F.conv3d {row['library_alone_ms']:.4f}", flush=True)
        result[name] = row
        del x, dy, xl, z, zc
        torch.cuda.empty_cache()
    (out / f"k4_{world}_{rank}.json").write_text(json.dumps(result))


def rank_train(out: Path, seed: int, bf16: bool) -> None:
    """One rank of phase 8b: the training CLI, ``--spmd --mesh-shape 1x2
    --distributed --pconv --pconv-all`` on the clip, all ten scales at
    ``--niter 2``.  Each step's wall time, peak memory and launches;
    K4's launches per scale-9 GAN step checked; the first scale-9 GAN
    step's metrics and the gradients that reach Adam (every optimizer
    step's, through a global step hook) saved, with the updated critic's
    tail bias; rank 0 copies scale 8's netG and netD_8 before scale 9
    trains, for the single-process reference."""
    import shutil

    import torch
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    from hpvaegan_tpu_torch.cli import train_video
    from hpvaegan_tpu_torch.utils.logger import kept_logging

    sfx, name = ("_bf16" if bf16 else ""), f"sharded CLI {dtype_name(bf16)}"
    stdout = sys.stdout
    want = {**{k: 0 for k in spmd_counts()},
            **{f"{k}{sfx}": n for k, n in SHARDED_STEP_LAUNCHES.items()}}
    run_dir = out / f"run_{dtype_name(bf16)}"
    state = {"t": 0.0, "counts": None, "record": False, "steps": [],
             "after": [], "metrics": None, "wall": [], "peak": [],
             "k4": 0}

    def grads(opt, args, kwargs):
        if state["record"]:
            state["steps"].append([None if p.grad is None else
                                   p.grad.detach().cpu().clone()
                                   for grp in opt.param_groups
                                   for p in grp["params"]])

    def params(opt, args, kwargs):
        if state["record"]:
            state["after"].append(opt.param_groups[-1]["params"][-1]
                                  .detach().cpu().clone())

    def mark():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state["t"], state["counts"] = time.perf_counter(), spmd_counts()

    def on_event(scale, event, it, info):
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t"]
        now = spmd_counts()
        delta = {k: now[k] - state["counts"][k] for k in now}
        peak = torch.cuda.max_memory_allocated()
        values = {k: float(v) for k, v in info.items()}
        print(f"{name} scale {scale} {event} {it}: {wall:.4f} s, {values}, "
              f"peak memory {peak} bytes, launches "
              f"{ {k: v for k, v in delta.items() if v} }", file=stdout,
              flush=True)
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"{name} scale {scale} {event} {it}: a value is not finite")
        if delta["plain"]:
            fail(f"the plain versions ran {delta['plain']} times")
        if scale == SCALE and event == "calibrate":
            if rank == 0:   # scale 8's files, complete since its barrier
                exp = experiment_dir(run_dir)
                shutil.copy(exp / "netG", out / f"netG_8_{dtype_name(bf16)}")
                shutil.copy(exp / f"netD_{SCALE - 1}",
                            out / f"netD_8_{dtype_name(bf16)}")
            state["record"] = True
        if event == "step":
            state["k4"] += delta[f"conv3d64_spmd{sfx}"]
            if scale == SCALE:
                state["wall"].append(wall)
                state["peak"].append(peak)
                if delta != want:
                    fail(f"a scale-{scale} GAN step of the {name} run "
                         f"launched {delta}, want {want}")
                if it == 0:
                    state["record"] = False
                    state["metrics"] = values
        mark()

    from hpvaegan_tpu_torch.parallel import maybe_initialize
    rank, world = maybe_initialize(True, device_type="cuda")
    flags = sharded_flags(seed, bf16) + [
        "--run-dir", str(run_dir), "--spmd", "--mesh-shape", CLI_MESH,
        "--distributed"]
    hooks = [register_optimizer_step_pre_hook(grads),
             register_optimizer_step_post_hook(params)]
    t0 = time.perf_counter()
    console = io.StringIO()   # the CLI's console log (rank 0: logbook.txt)
    with kept_logging(), contextlib.redirect_stdout(console):
        mark()
        cfg = train_video.main(flags, callback=on_event)
    for h in hooks:
        h.remove()
    if len(state["steps"]) != 2 or state["metrics"] is None:
        fail(f"{name}: recorded {len(state['steps'])} optimizer steps of "
             f"the first scale-{SCALE} GAN step, want 2")
    print(f"{name} rank {rank} ({sharded_label()}): {cfg.stop_scale + 1} "
          f"scales in "
          f"{time.perf_counter() - t0:.3f} s; scale-{SCALE} GAN steps "
          f"{[round(w, 4) for w in state['wall']]} s, peak memory "
          f"{state['peak']} bytes; K4 launches in the run {state['k4']}",
          flush=True)
    torch.save({"grads": state["steps"], "tail_bias": state["after"][0],
                "metrics": state["metrics"]},
               out / f"step_{dtype_name(bf16)}_{rank}.pt")
    (out / f"train_{dtype_name(bf16)}_{rank}.json").write_text(json.dumps(
        {"k4": state["k4"], "wall": state["wall"], "peak": state["peak"],
         "counts": spmd_counts()}))


def reference_step(dev, seed: int, out: Path, bf16: bool):
    """The first scale-9 GAN step of a single-process run of the sharded
    CLI run's flags (no --spmd, so no mesh; no --pfuse, as --spmd turns
    it off), in memory through ``train_scale``: scale 8's netG and
    netD_8 from the sharded run, stage 9 grown and the scale's loader,
    draws and calibration as the CLI makes them.  Returns its metrics,
    the gradients of its two optimizer steps and its critic's updated
    tail bias."""
    import torch
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    from hpvaegan_tpu_torch.core.config import build_parser, config_from_args
    from hpvaegan_tpu_torch.data.loader import make_loader
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                    make_generator)
    from hpvaegan_tpu_torch.train.trainer import train_scale
    from hpvaegan_tpu_torch.utils.saver import load_critic, restore_generator
    from hpvaegan_tpu_torch.utils.tools import seeded_generator

    name = dtype_name(bf16)
    cfg = config_from_args(build_parser("video").parse_args(
        sharded_flags(seed, bf16)))
    cfg.niter = 1
    cfg.adjust_scales()
    dataset = SingleVideoDataset(cfg)
    pyr = dataset.pyramid
    G = make_generator(cfg.generator, cfg, pyr, ndim=3)
    G.init(seeded_generator(seed, 7)).to(dev)
    raw = restore_generator(str(out / f"netG_8_{name}"), G)
    G.init_next_stage(seeded_generator(seed, 100 + SCALE, device=dev))
    D_prev = make_discriminator(cfg.discriminator, cfg, 3).to(dev)
    load_critic(str(out / f"netD_8_{name}"), D_prev)
    cfg.scale_idx, cfg.resumed_idx = SCALE, -1
    cfg.Noise_Amps = [float(a) for a in raw["noise_amps"]]
    cfg.fps, cfg.td = pyr.fps(SCALE), pyr.td(SCALE)
    cfg.fps_index = pyr.fps_index(SCALE)
    h0, w0 = pyr.shape2d(0)
    # the quirk, as the CLI set it at the first scale it trained
    cfg.Z_init_size = [cfg.batch_size, pyr.td(0), h0, w0, cfg.latent_dim]
    dataset.generate_frames(SCALE)
    steps, after = [], []

    def grads(opt, args, kwargs):
        steps.append([None if p.grad is None else
                      p.grad.detach().cpu().clone()
                      for grp in opt.param_groups for p in grp["params"]])

    def params(opt, args, kwargs):
        after.append(opt.param_groups[-1]["params"][-1].detach().cpu()
                     .clone())

    hooks = [register_optimizer_step_pre_hook(grads),
             register_optimizer_step_post_hook(params)]
    batches = make_loader(dataset, cfg, seed, SCALE, dev)
    try:
        _, _, hist = train_scale(cfg, G, batches, D_prev=D_prev, seed=seed)
    finally:
        batches.close()
        for h in hooks:
            h.remove()
    return ({k: float(v) for k, v in hist[0].items()}, steps, after[0])


def sharded_main_path(dev, seed: int):
    """Phase 8: K4 on 1x2 and 2x2 meshes of ranks on this card (8a), then
    the sharded training CLI in f32 and under --bf16 (8b), its first
    scale-9 GAN step held against the single-process reference.  Returns
    (the K4 kernel rows, the launches of the sharded CLI runs summed over
    the ranks)."""
    import torch
    out = Path(tempfile.mkdtemp(prefix="sharded_"))
    try:
        k4 = {}
        for world in SHARDED_MESHES:                          # phase 8a
            run_ranks(world, ["k4", "--out", str(out), "--seed", str(seed)],
                      f"K4 {SHARDED_MESHES[world]}")
            k4[world] = [json.loads((out / f"k4_{world}_{r}.json")
                                    .read_text()) for r in range(world)]
            if any(r["backend"] != "gloo" for r in k4[world]):
                fail(f"ranks sharing a card must talk over gloo: {k4[world]}")
        launched = {}
        for bf16 in (False, True):                            # phase 8b
            name = dtype_name(bf16)
            reset_counts()
            run_ranks(2, ["train", "--out", str(out), "--seed", str(seed)]
                      + (["--bf16"] if bf16 else []), f"sharded CLI {name}")
            ranks = [json.loads((out / f"train_{name}_{r}.json").read_text())
                     for r in range(2)]
            for key in ranks[0]["counts"]:
                launched[key] = launched.get(key, 0) + sum(
                    r["counts"][key] for r in ranks)
            got = [torch.load(out / f"step_{name}_{r}.pt",
                              weights_only=False) for r in range(2)]
            for a, b in zip(got[0]["grads"], got[1]["grads"]):
                for ga, gb in zip(a, b):
                    if (ga is None) != (gb is None) or (
                            ga is not None and not torch.equal(ga, gb)):
                        fail(f"the ranks' summed gradients differ ({name})")
            ref_metrics, ref_steps, ref_tail = reference_step(dev, seed, out,
                                                              bf16)
            check_sharded_step(name, bf16, got[0], ref_metrics, ref_steps,
                               ref_tail)
            torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4_mod
    label = sharded_label()
    rows = []
    for bf16 in (False, True):
        name = dtype_name(bf16)
        r0 = k4[2][0][name]   # rank 0 of the 1x2 mesh, the CLI's
        rows.append({
            "name": f"conv3d64_spmd{'_bf16' if bf16 else ''}",
            "route": "cuda", "source": f"{k4_mod.SOURCE} (around "
            f"{cp.SOURCE}, {cp.DW_SOURCE})", "replaces": k4_mod.REPLACES,
            "launches": None,
            "max_abs_err": max(r[name]["max_abs_err"] for w in k4
                               for r in k4[w]),
            "ms": r0["k4_ms"], "plain_ms": r0["plain_ms"],
            "bound_ms": r0["bound_ms"], "bound_by": r0["bound_by"],
            "library_ms": r0["library_ms"],
            "timed": f"mesh 1x2 rank 0, {label}, all ranks at once; the "
                     f"bound and F.conv3d on its haloed block "
                     f"{k4[2][0]['halo_shape']}",
            "per_rank": {f"{w}": [{k: r[name][k] for k in
                                   ("k4_ms", "exchange_ms", "k1_alone_ms",
                                    "library_alone_ms", "bound_ms")}
                                  for r in k4[w]] for w in k4}})
    return rows, launched


def check_sharded_step(name: str, bf16: bool, got: dict, ref_metrics: dict,
                       ref_steps: list, ref_tail) -> None:
    """The sharded run's first scale-9 GAN step against the single-process
    reference: every metric and the gradients of both optimizer steps
    (critic, generator) at the card-vs-CPU bars (f32: the tests' rtol /
    atol; bf16: BF16_MODEL_BAR of max(1, max|ref|)).  errG and the total
    read the critic after its Adam step, and the critic tail's bias has
    an exact gradient of 0, so Adam moves it by rounding noise times up
    to lr_d: those two metrics may differ by the measured difference of
    that bias (errG sums it one for one, times disc_loss_weight = 1)."""
    import numpy as np
    drift = abs(float(got["tail_bias"]) - float(ref_tail))

    def close(a, b, extra=0.0):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        if bf16:
            return err, err <= BF16_MODEL_BAR * max(
                1.0, float(np.abs(b).max())) + extra
        return err, bool(np.all(np.abs(a - b) <= ATOL + RTOL * np.abs(b)
                                + extra))

    worst = 0.0
    for key, value in ref_metrics.items():
        extra = drift if key in ("errG", "loss") else 0.0
        err, ok = close(got["metrics"][key], value, extra)
        print(f"{name} first scale-{SCALE} GAN step {key}: sharded "
              f"{got['metrics'][key]:.6f}, single process {value:.6f}",
              flush=True)
        if not ok:
            fail(f"{name}: the sharded step's {key} disagrees with the "
                 f"single-process step ({got['metrics'][key]} against "
                 f"{value})")
        worst = max(worst, err)
    if len(ref_steps) != 2 or len(got["grads"]) != 2:
        fail(f"{name}: {len(ref_steps)} reference optimizer steps")
    for which, a, b in zip(("critic", "generator"), got["grads"], ref_steps):
        if len(a) != len(b):
            fail(f"{name}: {which} gradients {len(a)} against {len(b)}")
        g_worst = 0.0
        for i, (ga, gb) in enumerate(zip(a, b)):
            if (ga is None) != (gb is None):
                fail(f"{name}: {which} gradient {i} is missing on one side")
            if ga is None:
                continue
            err, ok = close(ga.float().numpy(), gb.float().numpy())
            if not ok:
                fail(f"{name}: the sharded step's {which} gradient {i} "
                     f"{tuple(ga.shape)} disagrees, max_abs_err {err:.3e}")
            g_worst = max(g_worst, err)
        print(f"{name} first scale-{SCALE} GAN step, {which} gradients "
              f"before the update: {len(a)} tensors agree with the single-"
              f"process step, max_abs_err {g_worst:.3e}", flush=True)
    print(f"{name}: the sharded first scale-{SCALE} GAN step agrees with "
          f"the single-process one (metrics max_abs_err {worst:.3e}; the "
          f"critic tail bias moved {drift:.3e} apart)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    # phase 8 starts its ranks as this script with --rank (the launcher's
    # environment names each rank)
    ap.add_argument("--rank", choices=("k4", "train"), help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--bf16", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "hpvaegan_tpu_torch" / "csrc").is_dir():
        fail(f"no hpvaegan_tpu_torch/ beside {__file__}: run from the "
             f"root of the repository")
    if args.rank == "k4":
        return rank_k4(Path(args.out), args.seed)
    if args.rank == "train":
        return rank_train(Path(args.out), args.seed, args.bf16)
    # phases 3-4 with TF32 off: the f32 kernels' references (plain
    # versions, cuDNN yardsticks) and the bf16 plain versions' f32 sums are
    # full f32.  Phase 5 runs with PyTorch's own defaults, so that the
    # steps' full_f32 is what holds f32
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}; torch.cuda.get_device_name(0) = "
          f"{torch.cuda.get_device_name(0)}; device_count = "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from hpvaegan_tpu_torch.ops.kernels import _build
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    sources = ["conv3d_pack", "conv3d_dw", "conv3d_fuse", "conv3d_lrelu"]
    t0 = time.perf_counter()
    _build.build_all(sources)
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    for name in sources:
        print(_build.ptxas_report(name), flush=True)
    regs = {}
    for name in sources:
        regs.update(ptxas_kernels(_build.ptxas_report(name)))
    # the kernels redesigned for Hopper (and their other-dtype twins)
    for what, cfg, entry in (
            ("conv3d64_fwd bf16", cp.kernel_config(torch.bfloat16),
             "conv3d64_fwd_bf16_kernel"),
            ("conv3d64_fwd f32", cp.kernel_config(), "conv3d64_fwd_kernel"),
            ("conv3d64_dw bf16", cp.dw_kernel_config(torch.bfloat16),
             "conv3d64_dw_bf16_partial"),
            ("conv3d64_dw f32", cp.dw_kernel_config(), "conv3d64_dw_partial"),
            ("conv3d64_pair f32", cf.kernel_config(), "conv3d64_pair_kernel"),
            ("conv3d64_pair bf16", cf.kernel_config(torch.bfloat16),
             "conv3d64_pair_bf16_kernel")):
        print(f"{what} launch config: {cfg}; ptxas {regs.get(entry)}",
              flush=True)
    from hpvaegan_tpu_torch.ops.kernels import conv3d as k3
    for c_in, c_out in K3_CHANNELS:   # K3's instances at the main shapes
        cfg = k3.kernel_config(c_in, c_out)
        entry = {"wide": "conv3d_lrelu_wide",
                 "narrow_in": f"conv3d_lrelu_narrow_inILi{c_in}",
                 "narrow_out": ("conv3d_lrelu_narrow_out"
                                + ("_res" if cfg["resident_bytes"] else "")
                                + f"ILi{c_out}")}
        print(f"conv3d_lrelu {c_in} -> {c_out} launch config: {cfg}; ptxas "
              f"{regs.get(entry[cfg['instance']])}", flush=True)

    rows = [check_k1(dev), check_k1_dx(dev), check_k1_dw(dev),
            check_k2(dev)]                                   # phase 3
    torch.cuda.empty_cache()
    rows += check_k1_bf16(dev) + [check_k2_bf16(dev)]        # phase 3b
    torch.cuda.empty_cache()
    k3_rows = check_k3(dev)                                  # phase 3c
    torch.cuda.empty_cache()
    # the main paths: each reads the launches of its own run
    paths = {}
    for bf16 in (False, True):                               # phases 4, 4b
        check_card_against_cpu(dev, args.seed, bf16)
        paths[f"serving {dtype_name(bf16)}"] = serve_main_path(
            dev, args.seed, args.profile, bf16)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    print(f"training phase TF32 flags (PyTorch defaults): matmul "
          f"{tf32_defaults[0]}, cudnn {tf32_defaults[1]}", flush=True)
    for bf16 in (False, True):                               # phases 5, 5b
        check_train_card_against_cpu(dev, args.seed, bf16)
        paths[f"training {dtype_name(bf16)}"] = train_main_path(
            dev, args.seed, args.profile, bf16)
    with tempfile.TemporaryDirectory() as runs:
        runs = Path(runs)
        for bf16 in (False, True):                           # phases 6, 6b
            paths[f"training CLI {dtype_name(bf16)}"] = train_cli_main_path(
                dev, args.seed, runs / dtype_name(bf16), bf16)
        for bf16 in (False, True):                           # phase 6c
            paths[f"reproducible CLI {dtype_name(bf16)}"] = repro_main_path(
                dev, args.seed, runs, bf16)
        for bf16 in (False, True):                           # phase 11
            paths[f"VAE_nb {dtype_name(bf16)}"] = vae_nb_main_path(
                dev, args.seed, runs, bf16)
        paths["baselines"] = baselines_main_path(dev, args.seed,  # 12
                                                 runs)
        for bf16 in (False, True):                           # phase 7
            paths[f"generate {dtype_name(bf16)}"] = generate_main_path(
                dev, args.seed, experiment_dir(runs / dtype_name(bf16)),
                runs / "generate", bf16)
        paths["serve f32"] = serve_cli_main_path(             # phase 7b
            dev, args.seed, experiment_dir(runs / "f32"), runs / "serve")
        paths["eval"] = eval_main_path(dev, args.seed, runs)  # phase 9
    with tempfile.TemporaryDirectory() as work:               # phase 10
        paths["image"] = image_main_path(dev, args.seed, Path(work))
    torch.cuda.empty_cache()
    k4_rows, paths["sharded CLI"] = sharded_main_path(dev, args.seed)  # 8
    rows += k4_rows
    for name, launched in paths.items():
        print(f"launches, {name} path: {launched}", flush=True)
    for row in rows:
        row["launches"] = sum(p.get(row["name"], 0) for p in paths.values())
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on the main path")
    rows += k3_rows   # routed nowhere: its own phase's launches

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
