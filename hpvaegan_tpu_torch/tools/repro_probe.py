"""Do two training runs of the same seeds stay bit-equal, step by step?

    python -m hpvaegan_tpu_torch.tools.repro_probe [--scales 2,9]
        [--steps 3] [--bf16] [--seed 0] [--report-ops]

For each scale, the full-width 3D model of ``data/vids/wingsuit.avi``
(nfc 64, latent 128, 5 layers, vae_levels 3, pyramid to 144 x 256;
random weights from ``--seed``; ``--pconv --pconv-all --pfuse``, batch 2)
is copied twice on the card with its critic and optimizers, and both
copies take the same steps (a VAE step below ``vae_levels``, else a GAN
step) on the same inputs and draws.  After every step it prints the
step's wall time of each copy and, per kind (gradients, parameters,
buffers, metrics), how many tensors differ between the copies and the
largest difference, naming the first few tensors that differ in module
order: the first step that differs, and its gradients, point at the op.
Nothing is written.

``--report-ops`` then runs one more step of the first copy under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
each distinct warning: the stock operators that have no deterministic
implementation on this device.
"""
from __future__ import annotations

import argparse
import copy
import time
import warnings

import torch

from ..core.config import Config
from ..models.registry import make_discriminator, make_generator
from ..train import optim, steps

__all__ = ["main", "differences"]

FULL = dict(nfc=64, latent_dim=128, num_layer=5, enc_blocks=2, vae_levels=3,
            img_size=256, min_size=32, max_size=256,
            sampling_rates=(4, 3, 2, 1), pconv=True, pconv_all=True,
            pfuse=True)
BATCH, SHOWN = 2, 4


def differences(a: dict, b: dict):
    """``(n differing, max |a - b|, first differing names)`` of two
    dicts of tensors with the same keys, in key order."""
    names, worst = [], 0.0
    for name, x in a.items():
        y = b[name]
        if x is None or y is None:
            if (x is None) != (y is None):
                names.append(name)
            continue
        if not torch.equal(x, y):
            names.append(name)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return len(names), worst, names[:SHOWN]


def _state(G, D, metrics) -> dict:
    out = {"grads": {}, "params": {}, "buffers": {}, "metrics": {}}
    for prefix, m in (("G.", G), ("D.", D)):
        if m is None:
            continue
        for name, p in m.named_parameters():
            out["params"][prefix + name] = p.detach().clone()
            out["grads"][prefix + name] = (None if p.grad is None
                                           else p.grad.detach().clone())
        for name, buf in m.named_buffers():
            out["buffers"][prefix + name] = buf.detach().clone()
    out["metrics"] = {k: v.detach().clone() for k, v in metrics.items()}
    return out


def _inputs(cfg, scale: int, it: int, seed: int, dev):
    pyr = cfg.pyramid()
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + scale * 100
                                                + it)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev)

    real = torch.tanh(draw(BATCH, *pyr.shape3d(scale), 3))
    real_zero = torch.tanh(draw(BATCH, *pyr.shape3d(0), 3))
    return dict(real=real, real_zero=real_zero,
                noise_init=draw(BATCH, *pyr.shape3d(0), cfg.latent_dim),
                noises=[draw(BATCH, *pyr.shape3d(i + 1), 3)
                        for i in range(scale)],
                eps=draw(BATCH, *pyr.shape3d(0), cfg.latent_dim),
                alpha=float(torch.rand((), generator=g, device=dev)))


def _step(cfg, model, x, amps, gan: bool):
    G, D, opt_g, opt_d = model
    if gan:
        return steps.gan_step(G, D, opt_g, opt_d, cfg, x["real"],
                              x["real_zero"], x["noise_init"], amps,
                              noises=x["noises"], eps=x["eps"],
                              alpha=x["alpha"])
    return steps.vae_step(G, opt_g, cfg, x["real"], x["real_zero"], amps,
                          eps=x["eps"])


def probe_scale(scale: int, n_steps: int, bf16: bool, seed: int, dev,
                report_ops: bool) -> bool:
    """Prints the comparison of each step; returns whether the two copies
    ended bit-equal."""
    cfg = Config(**FULL, bf16=bf16)
    cfg.ar, cfg.org_fps = 144 / 256, 24.0
    cfg.adjust_scales()
    cfg.scale_idx = scale
    gan = cfg.vae_levels < scale + 1
    gen = torch.Generator().manual_seed(seed)
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(gen)
    for _ in range(scale):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = None
    if gan:
        D = make_discriminator(cfg.discriminator, cfg, 3)
        D.reset_parameters(torch.Generator().manual_seed(seed + 1))
    models = []
    for _ in range(2):
        g, d = copy.deepcopy(G).to(dev), copy.deepcopy(D)
        d = d.to(dev) if d is not None else None
        models.append((g, d, optim.build_g_optimizer(cfg, g, scale),
                       optim.build_d_optimizer(cfg, d) if gan else None))
    amps = [1.0] + [cfg.noise_amp] * scale
    tag = f"scale {scale} ({'GAN' if gan else 'VAE'}, " \
          f"{'bf16' if bf16 else 'f32'})"
    equal = True
    for it in range(n_steps):
        x = _inputs(cfg, scale, it, seed, dev)
        states, times = [], []
        for model in models:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            metrics = _step(cfg, model, x, amps, gan)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            states.append(_state(model[0], model[1], metrics))
        said = []
        for kind in ("grads", "params", "buffers", "metrics"):
            n, worst, names = differences(states[0][kind], states[1][kind])
            equal &= n == 0
            said.append(f"{kind} {n} differ (max {worst:.3e})"
                        + (f" first {names}" if names else ""))
        print(f"{tag} step {it}: {times[0]:.4f} s / {times[1]:.4f} s; "
              + "; ".join(said), flush=True)
    if report_ops:
        x = _inputs(cfg, scale, n_steps, seed, dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                _step(cfg, models[0], x, amps, gan)
                torch.cuda.synchronize(dev)
            finally:
                torch.use_deterministic_algorithms(False)
        seen = sorted({str(w.message).split("\n")[0] for w in caught})
        print(f"{tag}: {len(seen)} distinct determinism warnings", flush=True)
        for line in seen:
            print(f"  {line}", flush=True)
    print(f"{tag}: the two copies {'ARE' if equal else 'are NOT'} bit-equal "
          f"after {n_steps} steps", flush=True)
    del models, G, D
    torch.cuda.empty_cache()
    return equal


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", default="2,9")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report-ops", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe compares runs on the card")
    print(f"cudnn.deterministic {torch.backends.cudnn.deterministic}, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}", flush=True)
    for scale in (int(s) for s in args.scales.split(",")):
        probe_scale(scale, args.steps, args.bf16, args.seed, dev,
                    args.report_ops)


if __name__ == "__main__":
    main()
