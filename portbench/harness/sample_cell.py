"""A sampling cell: what ``cli.generate`` users pay for each clip.

Set-up writes the benchmark's generator (weights from ``--seed``) as a
``netG`` checkpoint with its ``config.json`` into a directory of its own
under the run's temporary directory, loads it into the measured
package's ``serving.SamplerSession`` as the CLI does, and warms it up.

One client in a closed loop: request ``i`` draws its inputs (the model
family's ``request_draws``; HP-VAE-GAN: its decoder latent and stage
noises) on the card from ``seed_value(seed, REQUEST_KEY, i)`` (the
benchmark's inputs, handed to ``SamplerSession.sample_batch``), and is
complete when its clips are on the host.  Its latency runs from before
its draws to then.  The window starts after ``warmup_requests`` and ends
with the first request that completes at or past ``--seconds``.
``compare_requests`` request indices below ``compare_below`` are drawn
from the seed; their clips are kept, and the reference recomputes them
from the same draws after the window (``--seconds`` 0: the window is
those ``compare_below`` requests).
With ``--trace 1`` the profiler covers the window's first
``trace_requests`` requests and the window ends with them."""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from reference.train import seed_value

from .common import (Run, note, peak_bytes, precision, reserved_peak_bytes,
                     reset_peak, sync)
from .spans import SetupSpans
from .launches import LaunchLog
from .models import port_config, reference_models
from .trace import Tracer
from .train_cell import reference_pyramid
from .yardstick import request_flops

__all__ = ["run_sample", "REQUEST_KEY", "request_draws", "window_metrics",
           "p95_ms"]

REQUEST_KEY = 0x5A3
WARMUP_KEY = 0x5A4
_PICK_KEY = 0x9C4


def request_draws(family, G, conf: dict, dev, seed: int, i: int,
                  key: int = REQUEST_KEY):
    """Request ``i``'s draws, channels last, as ``family.request_draws``
    makes them for the reference generator ``G``, from one generator on
    ``dev`` seeded ``seed_value(seed, key, i)``."""
    g = torch.Generator(device=dev).manual_seed(seed_value(seed, key, i))
    return family.request_draws(G, conf, g, dev)


def _session(conf: dict, scale: int, G_ref, amps, dev, workdir: str):
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    from hpvaegan_tpu_torch.utils.saver import save_generator
    cfg = port_config(conf, scale)
    SingleVideoDataset(cfg)          # the clip's aspect ratio and rate
    netG = os.path.join(workdir, "netG")
    save_generator(netG, G_ref, scale, amps)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump(cfg.snapshot_dict(), f)
    scfg = Config(netG=netG)
    apply_snapshot(scfg, netG, explicit=set(), user_chose_source=False)
    scfg.adjust_scales()
    session = SamplerSession(scfg, batch_size=conf["batch_size"],
                             manual_seed=0, device=dev)
    session.warmup(("rand",))
    return session


def run_sample(cell, seed: int, seconds: float, trace: bool, dev, run: Run,
               conf: Optional[dict] = None) -> dict:
    conf = dict(cell.config if conf is None else conf)
    fam, tr = cell.family, cell.traffic
    scale, ndim = int(tr["scale"]), int(conf["ndim"])
    t = time.perf_counter()
    pyr = reference_pyramid(conf)
    shapes = [pyr.thw(i) if ndim == 3 else pyr.hw(i)
              for i in range(scale + 1)]
    G_ref, _ = reference_models(fam, conf, ndim, shapes, scale, dev, seed)
    amps = fam.amps_before(conf, scale) + [float(conf["noise_amp"])]
    t = run.mark("weights", t)
    log = LaunchLog().install() if trace else None
    tracer = Tracer(dev) if trace else None
    # the compared requests: drawn from the seed among the first
    # compare_below (a traced window's first trace_requests), all due in
    # any window of the cell
    below = int(tr["trace_requests"] if trace else tr["compare_below"])
    rng = np.random.default_rng(seed_value(seed, _PICK_KEY))
    picked = set(int(i) for i in rng.choice(
        below, min(below, int(tr["compare_requests"])), replace=False))
    kept = {}
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        spans = SetupSpans(run, dev).install()
        try:
            session = _session(conf, scale, G_ref, amps, dev, work)
        finally:
            spans.remove()
        t = run.mark("load and warm-up", t)
        for i in range(int(tr["warmup_requests"])):
            z, noises = request_draws(fam, G_ref, conf, dev, seed, i,
                                      WARMUP_KEY)
            session.sample_batch(noise=z, noises=noises)
        sync(dev)
        run.mark("warm-up requests", t)
        pshape = (session.G.pyramid.shape3d if ndim == 3
                  else session.G.pyramid.shape2d)
        if [pshape(j) for j in range(scale + 1)] != shapes:
            raise RuntimeError("the session's pyramid differs from the "
                               "reference's")
        run.memory_peak_bytes = peak_bytes(dev)
        reset_peak(dev)
        if log is not None:
            log.phase = "trace"
        run.setup_s = time.perf_counter() - run.t0
        if tracer is not None:
            tracer.start()
        start = time.perf_counter()
        i = 0
        while True:
            t_req = time.perf_counter()
            z, noises = request_draws(fam, G_ref, conf, dev, seed, i)
            out = session.sample_batch(noise=z, noises=noises)
            done = time.perf_counter()
            run.latencies_ms.append((done - t_req) * 1e3)
            if i in picked:
                kept[i] = out
            i += 1
            if tracer is not None:
                if i >= int(tr["trace_requests"]):
                    run.trace = tracer.stop()
                    run.window_s = run.trace.window_s
                    break
            elif (done - start >= seconds if seconds > 0
                  else i >= below):
                run.window_s = done - start
                break
        run.units = i
        run.clips = i * conf["batch_size"]
        run.window_reserved_bytes = reserved_peak_bytes(dev)
        run.memory_peak_bytes = max(run.memory_peak_bytes, peak_bytes(dev))
        if log is not None:
            log.remove()
            run.launches = log
        del session
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if trace:
        run.flops_per_unit = request_flops(conf, ndim, shapes, scale,
                                           conf["batch_size"])
    gap = 0.0
    with torch.no_grad(), precision(tf32=False):
        for j, out in sorted(kept.items()):
            z, noises = request_draws(fam, G_ref, conf, dev, seed, j)
            ref = fam.reference_clip(G_ref, amps, z, noises).cpu().numpy()
            d = (float(np.abs(out - ref).max()) if out.shape == ref.shape
                 and np.isfinite(out).all() else math.inf)
            gap = max(gap, d)
    lat = run.latencies_ms
    half = len(lat) // 2
    note(f"compared requests {sorted(kept)} of {run.units}; latency ms: "
         f"mean {statistics.fmean(lat):.3f}, median "
         f"{statistics.median(lat):.3f}, 95th percentile {p95_ms(lat):.3f}, "
         f"min {min(lat):.3f}, max {max(lat):.3f}, first half mean "
         f"{statistics.fmean(lat[:half] or lat):.3f}, second half mean "
         f"{statistics.fmean(lat[half:]):.3f}")
    return {"clip_gap": gap if kept else math.inf}


def p95_ms(latencies_ms) -> float:
    """The 95th percentile (nearest rank) of the requests' latencies."""
    lat = sorted(latencies_ms)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def window_metrics(run: Run) -> dict:
    """The end-to-end metric of a sampling window: clips over the whole
    window."""
    return {"sample_clips_per_s": run.clips / run.window_s}
