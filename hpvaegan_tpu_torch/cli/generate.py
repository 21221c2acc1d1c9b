"""Standalone sampling CLI (port of ``hpvaegan_tpu/cli/generate.py:34-255``).

    python -m hpvaegan_tpu_torch.cli.generate \\
        --netG run/wingsuit/DEBUG/experiment_0/netG --num-samples 8

loads a trained checkpoint (the port's or the JAX package's; the
experiment's ``config.json`` snapshot rebuilds the training model, and an
explicit flag wins over it) and writes novel samples (``--mode rand``),
reconstructions (``--mode rec``) or injections of the real clip refined
from a pyramid level upward (``--inject-scale``), batched over seeds, as
``sample_{i}.avi`` / ``inject_{i}.avi`` (uncompressed, see
``utils/video_io.py``), or ``.png`` for a 2D model (``--image-path``, or
an image run's snapshot), into ``--output-dir`` (default ``<ckpt
dir>/eval``).  ``--h/w/t-factor`` sample at a multiple of the training
geometry, and ``--metrics`` logs the diversity (rand, inject) or the
reconstruction PSNR (rec).  ``--svfid`` (3D) and ``--sifid`` (2D) score
the samples against the real sample at the checkpoint's scale on the
session's device (``eval/``), with the JAX CLI's log lines.  It samples
on the card; ``--no-cuda`` on the CPU.

The parser is the JAX CLI's, flag for flag.  Batch ``i`` draws from
``seeded_generator(manualSeed, 1000 + i)`` (inject: ``3000 + i``) where
the JAX CLI folds the same numbers into its root key.

``--mesh-shape DxS`` samples each batch over a (data, spatial) mesh of
ranks (``SamplerSession(mesh_shape=...)``; JAX ``cli/generate.py:95-97,
131-134``).  A process is a rank when the launcher's environment names
it (``parallel/distributed.py`` ``LAUNCHER_VARS``); otherwise the command
starts the D*S ranks itself on this host (``parallel/launch.py``), one a
card, gloo CPU ranks under ``--no-cuda``, and refuses a mesh larger than
the host's cards.  Every rank samples every batch; only rank 0 writes the
files and logs the metrics.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from .. import resolve_device
from ..eval import diversity_score, reconstruction_psnr, sifid, svfid
from ..parallel import multihost, parse_mesh_shape
from ..parallel.distributed import launcher_env
from ..parallel.launch import spawn_ranks
from ..serving import (SamplerSession, apply_snapshot, config_from_cli_args,
                       explicit_cli_keys)
from ..utils.tools import seeded_generator

__all__ = ["build_parser", "main", "launch_ranks", "open_session"]


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
                   help="SVFID of the samples vs the real clip")
    p.add_argument("--c3d-weights", type=str, default="",
                   help="torch C3D Sports-1M checkpoint for --svfid")
    p.add_argument("--svfid-layer", type=str, default="conv3b",
                   help="C3D tap layer for --svfid (conv1..conv5b)")
    p.add_argument("--sifid", action="store_true", default=False,
                   help="SIFID of the samples vs the real image")
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
                   help="shard the sample batch over a device mesh, e.g. 8")
    # pyramid injection (the reference's unused sample_init hook,
    # networks_3d.py:368-380): refine the REAL sample from level K upward
    p.add_argument("--inject-scale", type=int, default=-1,
                   help="start refinement from the real sample at this "
                        "pyramid level (rand mode above it)")
    return p


def launch_ranks(args, argv, module: str) -> bool:
    """Start the ranks of ``module`` on this host when ``--mesh-shape``
    asks for several and this process is none of them (no launcher
    environment, no process group up); returns whether it did, after
    they all ended."""
    if not args.mesh_shape or launcher_env() is not None \
            or dist.is_initialized():
        return False
    n = math.prod(parse_mesh_shape(args.mesh_shape))
    if n == 1:
        return False
    spawn_ranks(list(sys.argv[1:] if argv is None else argv), n,
                args.no_cuda, module=module, flags=())
    return True


def open_session(args, build, argv=None,
                 check_metrics: bool = True) -> SamplerSession:
    """The snapshot-configured session of parsed ``args`` (``build`` is
    the parser factory that parsed them), on the card unless
    ``--no-cuda``.  ``check_metrics``: refuse ``--svfid`` on a 2D model
    and ``--sifid`` on a 3D one, as the JAX generate CLI does; the server,
    which scores nothing, takes and ignores both, as the JAX server
    does."""
    device = resolve_device("cpu" if args.no_cuda else "cuda")
    cfg = config_from_cli_args(args)
    # `--netG <ckpt>` alone rebuilds the training module tree from the
    # experiment's config.json snapshot; explicit flags win
    apply_snapshot(cfg, args.netG, explicit_cli_keys(build, argv),
                   user_chose_source=bool(args.video_path
                                          or args.image_path))
    cfg.adjust_scales()
    ndim = 3 if cfg.video_path else 2
    if check_metrics and args.svfid and ndim != 3:
        raise ValueError("--svfid is a video metric (needs --video-path)")
    if check_metrics and args.sifid and ndim != 2:
        raise ValueError("--sifid is an image metric (needs --image-path)")
    return SamplerSession(cfg, batch_size=args.batch_size,
                          manual_seed=args.manualSeed,
                          h_factor=args.h_factor, w_factor=args.w_factor,
                          t_factor=args.t_factor,
                          mesh_shape=args.mesh_shape, device=device)


def report_svfid(sess: SamplerSession, args, samples) -> dict:
    """SVFID of generated clips against the real clip at the
    checkpoint's scale (shapes need not match: the statistics are per
    position), logged as the JAX CLI logs it."""
    res = svfid(sess.real_clip(sess.scale), samples,
                weights_path=args.c3d_weights,
                feature_layer=args.svfid_layer, device=sess.device)
    tag = "" if res["pretrained"] else " (RANDOM C3D — relative only)"
    logging.info(f"SVFID[{res['feature_layer']}]{tag}: "
                 f"mean {res['mean']:.4f}  per-sample "
                 f"{[round(s, 4) for s in res['per_sample']]}")
    return res


def report_sifid(sess: SamplerSession, args, samples) -> dict:
    """SIFID of generated images against the real image at the
    checkpoint's scale, logged as the JAX CLI logs it."""
    res = sifid(sess.real_clip(sess.scale), samples,
                weights_path=args.inception_weights, tap=args.sifid_layer,
                device=sess.device)
    tag = "" if res["pretrained"] else " (RANDOM stem — relative only)"
    logging.info(f"SIFID[{res['tap']}]{tag}: "
                 f"mean {res['mean']:.4f}  per-sample "
                 f"{[round(s, 4) for s in res['per_sample']]}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Generate as the command line says.  Returns what was written:
    ``paths``, the ``samples`` array, ``batch_ms`` (each batch's sampler
    call, output on the host), ``write_ms`` (each file), ``metrics``
    (with the ``svfid``/``sifid`` result dicts when asked for) and
    ``eval_ms`` (each of those scores' wall time, its trunk's build
    included).  Under ``--mesh-shape`` every rank returns its samples,
    and only rank 0 writes and scores them; the process that started
    the ranks returns ``{"output_dir", "ranks"}`` once they ended."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out_dir = args.output_dir or os.path.join(os.path.dirname(args.netG),
                                              "eval")
    if launch_ranks(args, argv, "hpvaegan_tpu_torch.cli.generate"):
        return {"output_dir": out_dir,
                "ranks": math.prod(parse_mesh_shape(args.mesh_shape))}
    sess = open_session(args, build_parser, argv)
    dev, scale = sess.device, sess.scale
    primary = multihost.is_primary()
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    inject = args.inject_scale >= 0
    if inject:
        if not sess.is_triple:   # as the JAX CLI (generate.py:178-179)
            raise ValueError("--inject-scale requires GeneratorHPVAEGAN")
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
            if primary:
                t0 = time.perf_counter()
                result["paths"].append(
                    sess.write_sample(clip, os.path.join(out_dir, name)))
                result["write_ms"].append((time.perf_counter() - t0) * 1e3)
            samples.append(clip)
        batch_idx += 1
    result["samples"] = np.stack(samples)
    result["eval_ms"] = {}
    if not primary:
        return result
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
    for name, asked, report in (("svfid", args.svfid, report_svfid),
                                ("sifid", args.sifid, report_sifid)):
        if asked:
            t0 = time.perf_counter()
            result["metrics"][name] = report(sess, args, samples)
            result["eval_ms"][name] = (time.perf_counter() - t0) * 1e3
    return result


if __name__ == "__main__":
    main()
