#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hpvaegan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also print a torch.profiler table

Phases; any failure exits non-zero and prints no result:

1. the card: name, power limit, device count;
2. the build: every kernel of the path compiled from ``csrc/`` with nvcc
   (one process per source, all started together), with ptxas's registers,
   shared memory and spills;
3. each kernel against its plain PyTorch version at the main path's
   shapes (f32, TF32 off), with its time, the plain version's time, the
   time of one library call computing the same function, and the bound;
4. the main path at full width: the repository's default 3D
   GeneratorHPVAEGAN (nfc 64, latent 128, 5 layers, 3 VAE levels, pyramid
   to 256 px) on the in-repo wingsuit clip's geometry (256x144, 24 fps),
   grown to scale 9 with random weights from ``--seed``, saved as a port
   checkpoint + config.json and served through ``SamplerSession`` on the
   card: three rand requests at batch 2 under ``--pconv-all``, each
   checked for shape, finite values in [-1, 1] and 45 K1 launches;
   before that, the same model widths on a small pyramid agree between the
   card and the CPU path on the same draws;
5. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
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


def k1_bound(shape):
    """(bound_ms, bound_by): the larger of the f32 FMA time and the time
    to read x, w, b once and write y once."""
    voxels = shape[0] * shape[1] * shape[2] * shape[3]
    flops = 2 * 27 * 64 * 64 * voxels
    nbytes = 4 * (2 * voxels * 64 + 27 * 64 * 64 + 64)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
    return {"name": "conv3d64_fwd", "route": "cuda", "source": cp.SOURCE,
            "replaces": cp.REPLACES, "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


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
        print(f"small pyramid on {name}: K1 launches {cp.counts.launches}, "
              f"plain calls {cp.counts.plain_calls}", flush=True)
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
        before = cp.counts.launches
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = session.sample_batch()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        launched = cp.counts.launches - before
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
    launches, plain = cp.counts.launches, cp.counts.plain_calls
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
    # f32 everywhere on the card: the kernel is f32, and so are its
    # references (plain version, cuDNN yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}; torch.cuda.get_device_name(0) = "
          f"{torch.cuda.get_device_name(0)}; device_count = "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from hpvaegan_tpu_torch.ops.kernels import _build
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    t0 = time.perf_counter()
    _build.build_all(["conv3d_pack"])
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    print(_build.ptxas_report("conv3d_pack"), flush=True)
    print(f"conv3d64_fwd launch config: {cp.kernel_config()}", flush=True)

    k1 = check_k1(dev)
    check_card_against_cpu(dev, args.seed)
    k1["launches"] = serve_main_path(dev, args.seed, args.profile)

    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
