#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hpvaegan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also torch.profiler tables of one
                                       # request and of the scale-9 steps

Phases; any failure exits non-zero and prints no result:

1. the card: name, power limit, device count;
2. the build: every kernel of the path compiled from ``csrc/`` with nvcc
   (one process per source, all started together), with ptxas's registers,
   shared memory and spills;
3. each kernel against its plain PyTorch version at the main paths'
   shapes (f32, TF32 off), with its time, the plain version's time, the
   time of one library call computing the same function, and the bound:
   K1's forward, input gradient and weight gradient, and K2 (with and
   without its intermediate, and its backward);
4. the serving path at full width: the repository's default 3D
   GeneratorHPVAEGAN (nfc 64, latent 128, 5 layers, 3 VAE levels, pyramid
   to 256 px) on the in-repo wingsuit clip's geometry (256x144, 24 fps),
   grown to scale 9 with random weights from ``--seed``, saved as a port
   checkpoint + config.json and served through ``SamplerSession`` on the
   card: three rand requests at batch 2 under ``--pconv-all``, each
   checked for shape, finite values in [-1, 1] and 45 K1 launches;
   before that, the same model widths on a small pyramid agree between the
   card and the CPU path on the same draws;
5. the training path at full width, under ``--pconv --pconv-all --pfuse``
   with PyTorch's default TF32 flags (the steps hold f32 themselves):
   first one GAN step of the full-width model on a small pyramid on the
   card and on the CPU path from the same weights and draws (losses, BN
   statistics and spectral u/v agree); then ``train_scale`` at scale 2
   (2 VAE iterations) and at scale 9 (3 GAN iterations, the generator's
   top stage (2, 13, 144, 256), the critic on (4, 13, 144, 256, 3)) on
   clips made from ``--seed``, each step's wall time, losses, peak memory
   and launches per kernel printed and the launches checked;
6. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
# f32 outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain version: max |y_kernel - y_plain| <= KERNEL_TOL * max(1, max|y_plain|)
# (both f32; only the summation order differs)
KERNEL_TOL = 1e-4
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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the f32 FMA time and the time
    to move ``nbytes`` once."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def voxels(shape) -> int:
    return shape[0] * shape[1] * shape[2] * shape[3]


def k1_bound(shape, bias: bool = True):
    """One conv: 2*27*64*64 FLOP per voxel; x, w (and b) read once, y
    written once."""
    v = voxels(shape)
    return bound(2 * 27 * 64 * 64 * v,
                 4 * (2 * v * 64 + 27 * 64 * 64 + 64 * bias))


def dw_bound(shape):
    """The weight gradient: the forward's FLOPs; x and dy read once, dw
    written once."""
    v = voxels(shape)
    return bound(2 * 27 * 64 * 64 * v, 4 * (2 * v * 64 + 27 * 64 * 64))


def pair_bound(shape, with_mid: bool = False):
    """Two convs' FLOPs; x read once, y (and z) written once, the two
    weights and biases read once."""
    v = voxels(shape)
    return bound(2 * 2 * 27 * 64 * 64 * v,
                 4 * ((2 + with_mid) * v * 64 + 2 * (27 * 64 * 64 + 64)))


def check_close(what: str, got, ref) -> float:
    """max |got - ref| against KERNEL_TOL * max(1, max|ref|); fails the
    run on a miss or a non-finite value."""
    import torch
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"{what}: max_abs_err {err:.3e} (tolerance "
          f"{KERNEL_TOL * scale:.3e})", flush=True)
    if not bool(torch.isfinite(got).all()) or err > KERNEL_TOL * scale:
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
    for shape in (CRITIC_SHAPE, SMALL_SHAPE, (1, 1, 8, 14, 64)):
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
    return kernel_row("conv3d64_pair", cf.SOURCE, cf.REPLACES, worst, ms,
                      plain_ms, b, None)


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


def check_card_against_cpu(dev, seed: int) -> None:
    """Full model widths on a small pyramid: the card (K1 + cuDNN) and
    the CPU path (plain versions) on the same weights and draws."""
    import copy

    import numpy as np
    import torch
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp

    cfg = main_config(img_size=48, min_size=24, max_size=48)
    scale = cfg.stop_scale
    G = build_generator(cfg, scale, seed)
    pyr = cfg.pyramid()
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((BATCH, *pyr.shape3d(0), cfg.latent_dim),
                            dtype=np.float32)
    noises = [rng.standard_normal((BATCH, *pyr.shape3d(i + 1), 3),
                                  dtype=np.float32) for i in range(scale)]
    amps = [1.0] + [cfg.noise_amp] * scale
    outs = {}
    for name, model in (("cpu", G), ("cuda", copy.deepcopy(G).to(dev))):
        cp.counts.reset()
        with torch.inference_mode():
            out, _, _ = model.apply(amps, noise_init=z, mode="rand",
                                    train=True, noises=noises)
            outs[name] = out.cpu().numpy()
        print(f"small pyramid on {name}: K1 launches "
              f"{cp.counts.fwd_launches}, plain calls "
              f"{cp.counts.plain_calls}", flush=True)
    err = float(np.max(np.abs(outs["cuda"] - outs["cpu"])))
    print(f"card vs CPU path, {pyr.all_shapes3d()[-1]} at scale {scale}: "
          f"max_abs_err {err:.3e}", flush=True)
    if not np.allclose(outs["cuda"], outs["cpu"], rtol=RTOL, atol=ATOL):
        fail("the generator on the card disagrees with the CPU path")


def serve_main_path(dev, seed: int, profile: bool):
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    from hpvaegan_tpu_torch.utils.saver import save_generator

    cfg = main_config()
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
        scfg.adjust_scales()
        session = SamplerSession(scfg, batch_size=BATCH, manual_seed=seed,
                                 device=dev)
        session.warmup(("rand",))
        torch.cuda.synchronize()
        print(f"session: scale {session.scale}, built + saved + loaded + "
              f"warmed up in {time.perf_counter() - t0:.3f} s", flush=True)

    per_stage = 5 * SCALE
    torch.cuda.reset_peak_memory_stats(dev)
    cp.counts.reset()
    times = []
    for i in range(REQUESTS):
        before = cp.counts.fwd_launches
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = session.sample_batch()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        launched = cp.counts.fwd_launches - before
        want = (BATCH, *TOP_SHAPE[1:4], 3)
        print(f"request {i}: {times[-1]:.3f} ms, shape {out.shape}, "
              f"range [{out.min():.4f}, {out.max():.4f}], K1 launches "
              f"{launched}", flush=True)
        if out.shape != want:
            fail(f"sample shape {out.shape}, want {want}")
        if not np.all(np.isfinite(out)) or np.abs(out).max() > 1.0:
            fail("sample not finite or outside [-1, 1]")
        if launched != per_stage:
            fail(f"K1 launched {launched} times, want {per_stage}")
    launches, plain = cp.counts.fwd_launches, cp.counts.plain_calls
    if plain != 0:
        fail(f"the plain version ran {plain} times on the card")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"main path: {REQUESTS} requests, ms per request {times}, "
          f"peak memory {peak} bytes", flush=True)

    # K1's share of a request: its 45 launches timed at their shapes
    from hpvaegan_tpu_torch.ops.kernels.conv3d_pack import conv3d64
    w = torch.zeros((3, 3, 3, 64, 64), device=dev)
    b = torch.zeros(64, device=dev)
    k1_total = 0.0
    for idx in range(1, SCALE + 1):
        x = torch.randn((BATCH, *shapes[idx], 64), device=dev)
        k1_total += 5 * time_ms(lambda: conv3d64(x, w, b), iters=10)
    print(f"K1 time per request (45 launches at the stage shapes): "
          f"{k1_total:.4f} ms of {min(times):.3f} ms", flush=True)

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

def all_counts() -> dict:
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    return {"conv3d64_fwd": cp.counts.fwd_launches,
            "conv3d64_dx": cp.counts.dx_launches,
            "conv3d64_dw": cp.counts.dw_launches,
            "conv3d64_pair": cf.counts.launches,
            "plain": cp.counts.plain_calls + cf.counts.plain_calls}


def reset_counts() -> None:
    from hpvaegan_tpu_torch.ops.kernels import conv3d_fuse as cf
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    cp.counts.reset()
    cf.counts.reset()


def check_train_card_against_cpu(dev, seed: int) -> None:
    """One GAN step of the full-width model (critic included) on a small
    pyramid, on the card and on the CPU path, from the same weights and
    draws: losses, BN running statistics and spectral u/v agree."""
    import copy

    import numpy as np
    import torch
    from hpvaegan_tpu_torch.models.registry import make_discriminator
    from hpvaegan_tpu_torch.train import optim, steps

    cfg = main_config(img_size=48, min_size=24, max_size=48, **TRAIN_FLAGS)
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
        print(f"small-pyramid GAN step on {name}: {runs[name][0]}, "
              f"launches {all_counts()}", flush=True)
    (m_cpu, b_cpu), (m_gpu, b_gpu) = runs["cpu"], runs["cuda"]
    worst = 0.0
    for key in list(m_cpu) + list(b_cpu):
        a = np.asarray(m_gpu[key] if key in m_gpu else b_gpu[key])
        b = np.asarray(m_cpu[key] if key in m_cpu else b_cpu[key])
        if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"GAN step on the card disagrees with the CPU path in {key}:"
                 f" {np.max(np.abs(a - b)):.3e}")
        worst = max(worst, float(np.max(np.abs(a - b))))
    print(f"card vs CPU GAN step at scale {scale} "
          f"{pyr.shape3d(scale)}: losses, BN statistics and u/v agree, "
          f"max_abs_err {worst:.3e}", flush=True)


def train_main_path(dev, seed: int, profile: bool):
    """``train_scale`` at full width: scale 2 (VAE) and scale 9 (GAN).
    Returns the launches of the whole run, per kernel.  ``profile``: a
    torch.profiler table of the scale-9 run."""
    import contextlib

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
        cfg = main_config(niter=iters, **TRAIN_FLAGS)
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
            print(f"scale {scale} {event} {it}: {wall:.4f} s, {values}, "
                  f"peak memory {peak} bytes, launches {delta}", flush=True)
            if not all(math.isfinite(v) for v in values.values()):
                fail(f"scale {scale} {event} {it}: a loss is not finite")
            if delta["plain"]:
                fail(f"the plain versions ran {delta['plain']} times")
            if gan and event == "step":
                for name, want in GAN_STEP_LAUNCHES.items():
                    if delta[name] != want:
                        fail(f"{name} launched {delta[name]} times in a "
                             f"scale-{scale} GAN step, want {want}")
            mark()

        mark()
        tracer = contextlib.nullcontext()
        if profile and gan:
            from torch.profiler import ProfilerActivity, profile as prof
            tracer = prof(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
        with tracer:
            _, D, hist = train_scale(cfg, G, clips(cfg.pyramid(), scale),
                                     seed=seed, callback=on_event)
        if profile and gan:
            print(f"profile of train_scale at scale {scale} (calibration + "
                  f"{iters} steps):", flush=True)
            print(tracer.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25), flush=True)
        if len(hist) != iters or (D is not None) != gan:
            fail(f"train_scale at scale {scale} ran {len(hist)} steps")
        del G, D, hist
        torch.cuda.empty_cache()
    return all_counts()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "hpvaegan_tpu_torch" / "csrc").is_dir():
        fail(f"no hpvaegan_tpu_torch/ beside {__file__}: run from the "
             f"root of the repository")
    # phases 3-4 in f32 everywhere: the kernels are f32, and so are their
    # references (plain versions, cuDNN yardsticks).  Phase 5 runs with
    # PyTorch's own defaults, so that the steps' full_f32 is what holds f32
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
    sources = ["conv3d_pack", "conv3d_dw", "conv3d_fuse"]
    t0 = time.perf_counter()
    _build.build_all(sources)
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    for name in sources:
        print(_build.ptxas_report(name), flush=True)
    print(f"conv3d64_fwd launch config: {cp.kernel_config()}; "
          f"conv3d64_pair launch config: {cf.kernel_config()}", flush=True)

    rows = [check_k1(dev), check_k1_dx(dev), check_k1_dw(dev),
            check_k2(dev)]
    torch.cuda.empty_cache()
    check_card_against_cpu(dev, args.seed)
    served = serve_main_path(dev, args.seed, args.profile)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    print(f"training phase TF32 flags (PyTorch defaults): matmul "
          f"{tf32_defaults[0]}, cudnn {tf32_defaults[1]}", flush=True)
    check_train_card_against_cpu(dev, args.seed)
    trained = train_main_path(dev, args.seed, args.profile)
    print(f"launches: serving path {served} (conv3d64_fwd), training path "
          f"{trained}", flush=True)
    trained["conv3d64_fwd"] += served
    for row in rows:
        row["launches"] = trained[row["name"]]
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on the main path")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
