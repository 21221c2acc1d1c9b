"""Standalone sampling CLI (port of ``hpvaegan_tpu/cli/generate.py:34-255``).

    python -m hpvaegan_tpu_torch.cli.generate \\
        --netG run/wingsuit/DEBUG/experiment_0/netG --num-samples 8

loads a trained checkpoint (the port's or the JAX package's; the
experiment's ``config.json`` snapshot rebuilds the training model, and an
explicit flag wins over it) and writes novel samples (``--mode rand``),
reconstructions (``--mode rec``) or injections of the real clip refined
from a pyramid level upward (``--inject-scale``), batched over seeds, as
``sample_{i}.avi`` / ``inject_{i}.avi`` (uncompressed, see
``utils/video_io.py``) into ``--output-dir`` (default ``<ckpt dir>/eval``).
``--h/w/t-factor`` sample at a multiple of the training geometry, and
``--metrics`` logs the diversity (rand, inject) or the reconstruction
PSNR (rec).  It samples on the card; ``--no-cuda`` on the CPU.

The parser is the JAX CLI's, flag for flag.  Batch ``i`` draws from
``seeded_generator(manualSeed, 1000 + i)`` (inject: ``3000 + i``) where
the JAX CLI folds the same numbers into its root key.  Not ported yet,
and raising before anything is written: ``--svfid``/``--sifid`` (ROADMAP
Queue 1 item 10), 2D models (item 5), ``--mesh-shape`` (item 12).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np

from .. import resolve_device
from ..eval import diversity_score, reconstruction_psnr
from ..serving import (SamplerSession, apply_snapshot, config_from_cli_args,
                       explicit_cli_keys)
from ..utils.tools import seeded_generator

__all__ = ["build_parser", "main", "check_ported", "open_session"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--netG", required=True, help="path to trained netG")
    p.add_argument("--video-path", default="", help="source video (3D model)")
    p.add_argument("--image-path", default="", help="source image (2D model)")
    p.add_argument("--output-dir", default="", help="output dir (default: "
                   "<ckpt dir>/eval)")
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--mode", default="rand", choices=["rand", "rec"])
    p.add_argument("--metrics", action="store_true", default=False,
                   help="report diversity (rand) / PSNR (rec) metrics")
    p.add_argument("--svfid", action="store_true", default=False,
                   help="SVFID of the samples vs the real clip (not ported "
                        "yet: ROADMAP Queue 1 item 10)")
    p.add_argument("--c3d-weights", type=str, default="",
                   help="torch C3D Sports-1M checkpoint for --svfid")
    p.add_argument("--svfid-layer", type=str, default="conv3b",
                   help="C3D tap layer for --svfid (conv1..conv5b)")
    p.add_argument("--sifid", action="store_true", default=False,
                   help="SIFID of the samples vs the real image (not ported "
                        "yet: ROADMAP Queue 1 item 10)")
    p.add_argument("--inception-weights", type=str, default="",
                   help="torchvision inception_v3 state dict for --sifid")
    p.add_argument("--sifid-layer", type=str, default="pool1",
                   help="Inception-stem tap for --sifid "
                        "(Conv2d_1a_3x3/Conv2d_2a_3x3/Conv2d_2b_3x3/pool1)")
    p.add_argument("--manualSeed", type=int, default=0)
    # network/pyramid flags — must match training
    p.add_argument("--generator", type=str, default="GeneratorHPVAEGAN")
    p.add_argument("--nc-im", type=int, default=3)
    p.add_argument("--nfc", type=int, default=64)
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--vae-levels", type=int, default=3)
    p.add_argument("--enc-blocks", type=int, default=2)
    p.add_argument("--ker-size", type=int, default=3)
    p.add_argument("--num-layer", type=int, default=5)
    p.add_argument("--padd-size", type=int, default=1)
    p.add_argument("--scale-factor", type=float, default=0.75)
    p.add_argument("--min-size", type=int, default=32)
    p.add_argument("--max-size", type=int, default=256)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--sampling-rates", type=int, nargs="+",
                   default=[4, 3, 2, 1])
    p.add_argument("--stop-scale-time", type=int, default=-1)
    p.add_argument("--start-frame", default=0, type=int)
    p.add_argument("--max-frames", default=1000, type=int)
    p.add_argument("--train-all", action="store_true", default=False)
    p.add_argument("--no-cuda", action="store_true", default=False)
    p.add_argument("--bf16", action="store_true", default=False)
    # extrapolation: generate at a multiple of the training geometry
    p.add_argument("--h-factor", type=float, default=1.0)
    p.add_argument("--w-factor", type=float, default=1.0)
    p.add_argument("--t-factor", type=float, default=1.0)
    p.add_argument("--mesh-shape", type=str, default="",
                   help="shard the sample batch over a device mesh (not "
                        "ported yet: ROADMAP Queue 1 item 12)")
    # pyramid injection (the reference's unused sample_init hook,
    # networks_3d.py:368-380): refine the REAL sample from level K upward
    p.add_argument("--inject-scale", type=int, default=-1,
                   help="start refinement from the real sample at this "
                        "pyramid level (rand mode above it)")
    return p


def check_ported(args) -> None:
    """Raise for a flag whose feature the port lacks, before any work."""
    if args.svfid or args.sifid:
        raise NotImplementedError(
            f"{'--svfid' if args.svfid else '--sifid'} is not ported yet "
            f"(ROADMAP Queue 1 item 10: eval)")
    if args.image_path:
        raise NotImplementedError(
            "--image-path: 2D image sampling is not ported yet (ROADMAP "
            "Queue 1 item 5)")
    if args.mesh_shape:
        raise NotImplementedError(
            "--mesh-shape: sampling over several cards is not ported yet "
            "(ROADMAP Queue 1 item 12)")


def open_session(args, build, argv=None) -> SamplerSession:
    """The snapshot-configured session of parsed ``args`` (``build`` is
    the parser factory that parsed them), on the card unless
    ``--no-cuda``."""
    check_ported(args)
    device = resolve_device("cpu" if args.no_cuda else "cuda")
    cfg = config_from_cli_args(args)
    # `--netG <ckpt>` alone rebuilds the training module tree from the
    # experiment's config.json snapshot; explicit flags win
    apply_snapshot(cfg, args.netG, explicit_cli_keys(build, argv),
                   user_chose_source=bool(args.video_path
                                          or args.image_path))
    cfg.adjust_scales()
    return SamplerSession(cfg, batch_size=args.batch_size,
                          manual_seed=args.manualSeed,
                          h_factor=args.h_factor, w_factor=args.w_factor,
                          t_factor=args.t_factor, device=device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Generate as the command line says.  Returns what was written:
    ``paths``, the ``samples`` array, ``batch_ms`` (each batch's sampler
    call, output on the host), ``write_ms`` (each file) and ``metrics``."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    sess = open_session(args, build_parser, argv)
    dev, scale = sess.device, sess.scale

    out_dir = args.output_dir or os.path.join(os.path.dirname(args.netG),
                                              "eval")
    os.makedirs(out_dir, exist_ok=True)
    inject = args.inject_scale >= 0
    if inject:
        s0 = args.inject_scale
        stages = len(sess.G.body)
        if s0 >= stages:
            raise ValueError(
                f"--inject-scale {s0} out of range: checkpoint was trained "
                f"to scale {scale} with {stages} body stages")
        x_init = np.stack([sess.real_clip(s0)] * args.batch_size)
    real_top = sess.rec_input()[1] if args.mode == "rec" and not inject \
        else None

    result = {"output_dir": out_dir, "paths": [], "batch_ms": [],
              "write_ms": [], "metrics": {}}
    samples = []
    batch_idx = 0
    while len(samples) < args.num_samples:
        t0 = time.perf_counter()
        if inject:
            out = sess.inject_batch(x_init, s0, seeded_generator(
                args.manualSeed, 3000 + batch_idx, device=dev))
        else:
            g = seeded_generator(args.manualSeed, 1000 + batch_idx,
                                 device=dev)
            out = (sess.reconstruct_batch(None, g) if args.mode == "rec"
                   else sess.sample_batch(g))
        result["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        for clip in out[:args.num_samples - len(samples)]:
            name = f"{'inject' if inject else 'sample'}_{len(samples)}"
            t0 = time.perf_counter()
            result["paths"].append(
                sess.write_sample(clip, os.path.join(out_dir, name)))
            result["write_ms"].append((time.perf_counter() - t0) * 1e3)
            samples.append(clip)
        batch_idx += 1
    result["samples"] = np.stack(samples)
    if inject:
        logging.info(f"wrote {len(samples)} injected samples (from level "
                     f"{s0}) to {out_dir}")
    else:
        logging.info(f"wrote {len(samples)} samples to {out_dir}")

    if args.metrics:
        if real_top is not None:
            val = reconstruction_psnr(result["samples"],
                                      np.stack([real_top] * len(samples)))
            logging.info(f"reconstruction PSNR: {val:.2f} dB")
            result["metrics"]["psnr"] = val
        else:
            val = diversity_score(result["samples"])
            logging.info(f"sample diversity (mean pairwise L1): {val:.4f}")
            result["metrics"]["diversity"] = val
    return result


if __name__ == "__main__":
    main()
