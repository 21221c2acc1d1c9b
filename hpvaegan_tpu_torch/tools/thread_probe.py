"""Time a full-width sampler call in a thread that has made no CUDA call
yet, against the same call in a warm thread, and split the difference by
operator.

    python -m hpvaegan_tpu_torch.tools.thread_probe [--seed 0]

For f32 and bf16 in turn, a scale-9 ``SamplerSession`` of the full-width
3D model (random weights from ``--seed``, ``--pconv-all``, batch 2) is
warmed up on the main thread; then each line gives the wall ms of one
``sample_batch`` (it ends with the copy to the host, so it waits for the
card):

* ``main``: three more calls on the main thread;
* ``fresh``: a new thread's first and second call, three threads;
* ``device thread``: three calls that three new threads hand to one
  persistent ``cli.serve.DeviceThread``, warmed up once beforehand, as
  the server runs its requests;
* ``by op``: a new thread's first call against its second under
  ``torch.profiler`` (CPU activity), the operators whose self CPU time
  grew the most, with their call counts.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import torch

from ..cli.serve import DeviceThread
from ..core.config import Config
from ..models.registry import make_generator
from ..serving import SamplerSession, apply_snapshot
from ..utils.saver import save_generator

__all__ = ["main"]

# the full-width model of data/vids/wingsuit.avi (144 x 256 at 24 fps)
FULL = dict(nfc=64, latent_dim=128, num_layer=5, enc_blocks=2, vae_levels=3,
            img_size=256, min_size=32, max_size=256,
            sampling_rates=(4, 3, 2, 1), pconv_all=True,
            video_path="data/vids/wingsuit.avi")
SCALE, BATCH, TOP_OPS = 9, 2, 8


def full_session(seed: int, bf16: bool, device) -> SamplerSession:
    cfg = Config(**FULL, bf16=bf16)
    cfg.ar, cfg.org_fps = 144 / 256, 24.0
    cfg.adjust_scales()
    gen = torch.Generator().manual_seed(seed)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    with tempfile.TemporaryDirectory() as tmp:
        netG = os.path.join(tmp, "netG")
        save_generator(netG, G, SCALE, [1.0] + [cfg.noise_amp] * SCALE)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(cfg.snapshot_dict(), f)
        scfg = Config(netG=netG)
        apply_snapshot(scfg, netG, explicit=set(), user_chose_source=False)
        scfg.adjust_scales()
        return SamplerSession(scfg, batch_size=BATCH, manual_seed=seed,
                              device=device)


def timed(sess: SamplerSession) -> float:
    t0 = time.perf_counter()
    sess.sample_batch()
    return (time.perf_counter() - t0) * 1e3


def in_new_thread(fn):
    box = {}
    t = threading.Thread(target=lambda: box.update(out=fn()))
    t.start()
    t.join()
    return box["out"]


def self_cpu_us(sess: SamplerSession) -> dict:
    """Self CPU microseconds and calls of each operator in one call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.sample_batch()
    return {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages()}


def probe(sess: SamplerSession, name: str) -> None:
    sess.warmup(("rand",))
    print(f"{name} main: {[round(timed(sess), 3) for _ in range(3)]} ms",
          flush=True)
    for i in range(3):
        first, second = in_new_thread(lambda: (timed(sess), timed(sess)))
        print(f"{name} fresh thread {i}: first {first:.3f} ms, second "
              f"{second:.3f} ms", flush=True)
    device = DeviceThread()
    try:
        device.run(sess.warmup, ("rand",))
        ms = [in_new_thread(lambda: device.run(timed, sess))
              for _ in range(3)]
    finally:
        device.close()
    print(f"{name} device thread, from three new threads: "
          f"{[round(t, 3) for t in ms]} ms", flush=True)
    self_cpu_us(sess)   # the profiler's own first use, on the main thread
    first, second = in_new_thread(lambda: (self_cpu_us(sess),
                                           self_cpu_us(sess)))
    grew = sorted(first, key=lambda k: second.get(k, (0, 0))[0]
                  - first[k][0])
    total = sum(v[0] for v in first.values()) - sum(
        v[0] for v in second.values())
    print(f"{name} by op, a new thread's first call over its second: "
          f"{total / 1e3:.3f} ms of self CPU time in all", flush=True)
    for key in grew[:TOP_OPS]:
        was = second.get(key, (0, 0))[0]
        print(f"  {key}: {first[key][0] / 1e3:.3f} ms against "
              f"{was / 1e3:.3f} ms, {first[key][1]} calls", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("thread_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    for bf16 in (False, True):
        probe(full_session(args.seed, bf16, dev), "bf16" if bf16 else "f32")


if __name__ == "__main__":
    main()
