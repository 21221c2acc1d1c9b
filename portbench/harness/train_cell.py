"""A training cell: one GAN scale through the measured package's own
trainer, run by the model family's ``train`` (HP-VAE-GAN's: the trainer's
in-memory form, handed the generator, the device-resident frame cache and
the previous critic), stopped from its callback once the window has
closed.

Set-up builds the one generator, critic and optimizer state the window
drives: the calibration, then the scale's first steps through the
trainer's own call and feed: three eager steps, or under ``--scan-steps
K`` its first chunk of K (an eager step, the capture, replays).  The
reference follows them from the start afterwards: their losses, the first
step's gradients as the optimizers got them (worked out from Adam's first
moment after that step, ``m = (1 - beta1) g``) and every trained leaf's
change up to the window's start, where the parameters are copied before
the window's first step runs.

The window starts at a chunk boundary after a synchronisation and ends at
the first boundary at or past ``--seconds``; ``train_step_s`` is its time
over the steps it completed.  At each of its boundaries the program's
state (both models' tensors and both optimizers') is copied on the card,
so that once the window has closed the reference takes its last step or
chunk from the state before it and compares its losses and every leaf's
change.  With ``--trace 1`` the profiler covers as many steps as set-up
took (one chunk when replayed) and the window ends with them."""
from __future__ import annotations

import functools
import gc
import math
import statistics
import tempfile
import time
from typing import Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from reference.data import image_pair, read_frames, video_pair
from reference.geometry import Pyramid

from .common import (Run, Stop, note, peak_bytes, precision,
                     reserved_peak_bytes, reset_peak, sync)
from .compare import LOSS_STEPS, train_gaps, window_gaps
from .launches import LaunchLog
from .spans import SetupSpans
from .models import frames_file, port_config, reference_models
from .trace import Tracer
from .yardstick import step_flops

__all__ = ["run_train", "reference_batch", "reference_pyramid",
           "window_metrics", "first_steps", "last_segment"]


def first_steps(traffic: dict) -> int:
    """The steps set-up takes and the reference follows from the start:
    a chunk when replayed (``scan_steps`` K > 1), else ``LOSS_STEPS``."""
    k = int(traffic["scan_steps"])
    return k if k > 1 else LOSS_STEPS


def last_segment(traffic: dict) -> int:
    """The steps of the window's last boundary-to-boundary segment, which
    the reference takes from the program's state: a step or a chunk."""
    return int(traffic["scan_steps"])


def _dataset(cfg, ndim: int):
    if ndim == 3:
        from hpvaegan_tpu_torch.data.video import SingleVideoDataset
        return SingleVideoDataset(cfg)
    from hpvaegan_tpu_torch.data.image import SingleImageDataset
    return SingleImageDataset(cfg)


def reference_batch(conf: dict, pyr: Pyramid, scale: int, dev):
    """(real, real_zero) of the reference, in the model layout on ``dev``."""
    frames, _ = read_frames(frames_file(conf))
    batch = conf["batch_size"]
    if conf["ndim"] == 3:
        real, real_zero = video_pair(frames, pyr, scale, batch)
    else:
        real, real_zero = image_pair(frames[0], pyr, scale, batch)
    return tuple(torch.from_numpy(a).to(dev).movedim(-1, 1)
                 for a in (real, real_zero))


def reference_pyramid(conf: dict) -> Pyramid:
    frames, _ = read_frames(frames_file(conf))
    h, w = frames.shape[1:3]
    return Pyramid(conf["img_size"], conf["min_size"], conf["max_size"],
                   conf["scale_factor"], h / w, conf["sampling_rates"])


class _FirstSteps:
    """A global optimizer hook that, on the first (eager) step, keeps each
    optimizer and ``exp_avg / (1 - beta1)`` of each of its parameters."""

    def __init__(self):
        self.optimizers, self.grads = [], {}
        self._handle = register_optimizer_step_post_hook(self._hook)

    def _hook(self, opt, args, kwargs) -> None:
        if opt in self.optimizers or (
                torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return
        self.optimizers.append(opt)
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                self.grads[p] = (opt.state[p]["exp_avg"] / (1 - b1)).norm()
        if len(self.optimizers) == 2:
            self.close()

    def close(self) -> None:
        if self._handle is not None:
            self._handle.remove()
            self._handle = None


def _leaf_names(G, D_ref, optimizers):
    """{parameter: leaf name} of the optimizers' parameters: the
    generator's by its own names, the critic's by the reference critic's
    names in parameter order (``D.``-prefixed)."""
    gnames = {id(p): n for n, p in G.named_parameters()}
    names = {}
    for opt in optimizers:
        params = [p for g in opt.param_groups for p in g["params"]]
        if all(id(p) in gnames for p in params):
            names.update({p: gnames[id(p)] for p in params})
        else:
            ref = [f"D.{n}" for n, _ in D_ref.named_parameters()]
            if len(ref) != len(params):
                raise RuntimeError(f"the critic's optimizer holds "
                                   f"{len(params)} leaves, the reference "
                                   f"critic {len(ref)}")
            names.update(dict(zip(params, ref)))
    return names


def _trainer_critic(G, optimizers, keys) -> torch.nn.Module:
    """The critic that the package's trainer builds for itself: the live
    module that holds exactly the parameters of the optimizer that is not
    the generator's, with the state-dict keys ``keys``."""
    gparams = {id(p) for p in G.parameters()}
    ids = next([id(p) for g in opt.param_groups for p in g["params"]]
               for opt in optimizers
               if not all(id(p) in gparams for g in opt.param_groups
                          for p in g["params"]))
    keys = list(keys)
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.nn.Module) and \
                [id(p) for p in obj.parameters()] == ids and \
                list(obj.state_dict()) == keys:
            return obj
    raise RuntimeError("the trainer's critic was not found")


class _Snapshot:
    """The program's state at the window's latest boundary: the
    generator's and the critic's state dicts (the critic's under ``D.``)
    and each trained leaf's Adam state, copied on the card in place at
    every boundary."""

    def __init__(self, G, D, optimizers, names):
        self.live = dict(G.state_dict())
        self.live.update({f"D.{k}": v for k, v in D.state_dict().items()})
        self.adam = {names[p]: [opt.state[p][k] for k in
                                ("step", "exp_avg", "exp_avg_sq")]
                     for opt in optimizers for p in opt.state}
        self.model = {k: v.clone() for k, v in self.live.items()}
        self.moments = {n: [t.clone() for t in ts]
                        for n, ts in self.adam.items()}
        self.it = None

    @torch.no_grad()
    def take(self, it: int) -> None:
        for k, v in self.live.items():
            self.model[k].copy_(v)
        for n, ts in self.adam.items():
            for dst, src in zip(self.moments[n], ts):
                dst.copy_(src)
        self.it = it

    def state(self, shapes: dict) -> dict:
        """The model family's ``resume``'s ``state``, every tensor in the
        reference's layout (``shapes``: its shape by state key)."""
        return {"model": {k: _torch_layout(v, shapes[k])
                          for k, v in self.model.items()},
                "adam": {n: (float(step), _torch_layout(m, shapes[n]),
                             _torch_layout(v, shapes[n]))
                         for n, (step, m, v) in self.moments.items()}}


def _torch_layout(t: torch.Tensor, shape) -> torch.Tensor:
    """A tensor of the program's state in the reference's layout: a
    K1-routed conv holds its kernel, and Adam its moments, as THWIO
    ``(3, 3, 3, I, O)``, the package's checkpoint layout for such convs,
    which is ``(O, I, 3, 3, 3)`` permuted."""
    if tuple(t.shape) == tuple(shape):
        return t
    w = t.permute(4, 3, 0, 1, 2) if t.dim() == 5 else t
    if tuple(w.shape) != tuple(shape):
        raise RuntimeError(f"a state tensor of shape {tuple(t.shape)} "
                           f"where the reference holds {tuple(shape)}")
    return w


def _gp_ms(cfg, ndim: int, D_ref, real, dev, seed: int) -> Optional[float]:
    """One penalty and its backward on the trainer's critic route
    (``steps._penalty_critic`` over ``steps._critic`` and
    ``steps.calc_gradient_penalty``, as the GAN step calls them: a 3D K1
    critic's body on K1 unfused, other critics on stock convs) at the
    cell's critic and shapes, timed with CUDA events: the median of three
    after one untimed."""
    if dev.type != "cuda":
        return None
    from hpvaegan_tpu_torch import deterministic, full_f32
    from hpvaegan_tpu_torch.models.registry import make_discriminator
    from hpvaegan_tpu_torch.models.remat import remat_level
    from hpvaegan_tpu_torch.train import steps
    D = make_discriminator(cfg.discriminator, cfg, ndim).to(dev)
    D.load_state_dict(D_ref.state_dict())
    fmt = torch.channels_last_3d if ndim == 3 else torch.channels_last
    g = torch.Generator(device=dev).manual_seed(seed)
    x_real = real.contiguous(memory_format=fmt)
    x_fake = torch.tanh(torch.randn(real.shape, generator=g, device=dev)
                        ).contiguous(memory_format=fmt)
    alpha = torch.rand((), generator=g, device=dev)
    critic = steps._penalty_critic(D, steps._critic(D, cfg,
                                                    remat_level(cfg)))
    times = []
    with full_f32(), deterministic():
        for i in range(4):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            D.zero_grad(set_to_none=True)
            e0.record()
            gp = steps.calc_gradient_penalty(
                critic, x_real, x_fake, cfg.lambda_grad, alpha,
                chunked=steps._gp_chunked(cfg, D))
            gp.backward()
            e1.record()
            e1.synchronize()
            if i:
                times.append(e0.elapsed_time(e1))
    del D
    return statistics.median(times)


def run_train(cell, seed: int, seconds: float, trace: bool, dev, run: Run,
              conf: Optional[dict] = None) -> dict:
    """Drive the cell; fills ``run`` and returns the correctness numbers.
    ``seconds`` 0 closes the window at set-up's end (the first steps'
    numbers alone)."""
    from hpvaegan_tpu_torch.data.loader import make_loader

    conf = dict(cell.config if conf is None else conf)
    fam, tr = cell.family, cell.traffic
    scale, ndim, K = int(tr["scale"]), int(conf["ndim"]), int(tr["scan_steps"])
    first_n = first_steps(tr)
    t = time.perf_counter()

    cfg = port_config(conf, scale)   # niter as the source: the window ends
    cfg.scan_steps = K               # the scale long before
    cfg.manualSeed = seed
    cfg.Noise_Amps = fam.amps_before(conf, scale)
    dataset = _dataset(cfg, ndim)
    pyramid = dataset.pyramid
    shapes = [(pyramid.shape3d(i) if ndim == 3 else pyramid.shape2d(i))
              for i in range(scale + 1)]
    ref_pyr = reference_pyramid(conf)
    ref_shapes = [(ref_pyr.thw(i) if ndim == 3 else ref_pyr.hw(i))
                  for i in range(scale + 1)]
    batches = make_loader(dataset, cfg, seed, scale, dev)
    t = run.mark("data", t)

    G_ref, D_ref = reference_models(fam, conf, ndim, ref_shapes, scale, dev,
                                    seed)
    G = fam.port_generator(cfg, pyramid, ndim, scale, G_ref, dev)
    init = {n: p.detach().clone() for n, p in G.named_parameters()}
    init.update({f"D.{n}": p.detach().clone()
                 for n, p in D_ref.named_parameters()})
    sync(dev)
    t = run.mark("weights", t)

    spans = SetupSpans(run, dev).install()
    log = LaunchLog().install() if trace else None
    tracer = Tracer(dev) if trace else None
    first = _FirstSteps()
    st = {"phase": "setup", "t": t, "losses": {}, "amp": None, "base": 0,
          "stop_at": None, "snap": None}

    def boundary(done: int) -> None:
        """Steps ``0 .. done - 1`` have run; raises ``Stop`` once the
        window has closed and every step of it has reported."""
        sync(dev)
        now = time.perf_counter()
        if st["phase"] == "setup":
            if done < first_n:
                return
            run.mark("first steps", st["t"])
            spans.remove()
            names = _leaf_names(G, D_ref, first.optimizers)
            st["grads"] = {names[p]: float(v) for p, v in first.grads.items()}
            st["after"] = {n: p.detach().clone() for p, n in names.items()}
            st["names"] = names
            if seconds > 0:
                D = _trainer_critic(G, first.optimizers, D_ref.state_dict())
                st["snap"] = _Snapshot(G, D, first.optimizers, names)
                st["snap"].take(done)
            first.optimizers.clear()
            run.memory_peak_bytes = peak_bytes(dev)
            reset_peak(dev)
            st.update(phase="window", base=done, t_start=time.perf_counter())
            run.setup_s = st["t_start"] - run.t0
            if tracer is not None:
                log.phase = "trace"
                tracer.start()
                st["t_start"] = time.perf_counter()
            if seconds <= 0:   # once the chunk's steps have reported
                st["stop_at"] = done
            return
        steps_in = done - st["base"]
        if tracer is not None and steps_in >= first_n:
            run.trace = tracer.stop()
        elif tracer is not None or now - st["t_start"] < seconds:
            st["snap"].take(done)
            return
        run.window_s = (run.trace.window_s if run.trace is not None
                        else now - st["t_start"])
        run.units = steps_in
        st.update(phase="closed", stop_at=done, end=done,
                  live={n: p.detach().clone()
                        for p, n in st["names"].items()})

    def callback(event: str, it: int, info: dict) -> None:
        if event == "calibrate":
            st["amp"] = float(info["noise_amp"])
            sync(dev)
            st["t"] = run.mark("calibration", st["t"])
        elif event == "step":
            # a chunk's steps report after its boundary: by iteration
            st["losses"][it] = torch.stack([info[k].float()
                                            for k in fam.LOSS_TERMS])
            if K == 1 and st["phase"] != "closed":
                boundary(it + 1)
            if st["stop_at"] == it + 1:
                raise Stop
        elif event == "chunk":
            boundary(it + info["k"])

    try:
        with tempfile.TemporaryDirectory(prefix="portbench-") as work:
            fam.train(cfg, G, D_ref, batches, dataset, work, seed, callback)
        raise RuntimeError("the scale ended before the window closed")
    except Stop:
        pass
    finally:
        first.close()
        spans.remove()
        if log is not None:
            log.remove()
    run.window_reserved_bytes = reserved_peak_bytes(dev)
    run.memory_peak_bytes = max(run.memory_peak_bytes, peak_bytes(dev))
    every = {it: tuple(float(v) for v in pair)
             for it, pair in sorted(st["losses"].items())}
    run.failed = sum(not all(math.isfinite(v) for v in pair)
                     for it, pair in every.items() if it >= first_n)
    losses = [every[it] for it in range(first_n) if it in every]
    grads, after = st.get("grads", {}), st.get("after", {})
    change = {n: float(torch.linalg.vector_norm(p - init[n]))
              for n, p in after.items()}
    snap, window = st["snap"], None
    if snap is not None and "end" in st:
        start, end = snap.it, st["end"]
        window = {"start": start, "steps": end - start,
                  "state": snap.state({k: v.shape for k, v in
                                       fam.model_state(G_ref,
                                                       D_ref).items()}),
                  "losses": [every[it] for it in range(start, end)
                             if it in every],
                  "change": {n: float(torch.linalg.vector_norm(
                      p - snap.model[n])) for n, p in st["live"].items()}}
    amp = st["amp"]
    del G, batches, dataset, first, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    real, real_zero = reference_batch(conf, ref_pyr, scale, dev)
    if trace:
        run.launches = log
        run.flops_per_unit = step_flops(conf, ndim, ref_shapes, scale,
                                        conf["batch_size"])
        run.gp_ms = _gp_ms(cfg, ndim, D_ref, real, dev, seed)
    amps = fam.amps_before(conf, scale)
    step_gaps = functools.partial(fam.loss_gaps, conf=conf)
    with precision(tf32=False):
        ref = fam.follow(G_ref, D_ref, conf, real, real_zero, amps, dev,
                         seed, scale, first_n)
        gaps = train_gaps(losses, grads, change, ref, step_gaps)
        if window is not None:
            seg = fam.resume(G_ref, D_ref, conf, real, real_zero,
                             amps + [ref["amp"]], dev, seed, scale,
                             window["state"], window["start"],
                             window["steps"])
            gaps.update(window_gaps(window["losses"], window["change"], seg,
                                    ref["grads"], step_gaps))
        elif seconds > 0:
            gaps.update(window_loss_gap=math.inf, window_change_gap=math.inf)
    if shapes != ref_shapes or amp is None:
        gaps = {k: math.inf for k in gaps}
    note(f"calibrated amp: program {amp!r}, reference {ref['amp']!r}")
    for j, (p, r) in enumerate(zip(losses, ref["losses"])):
        note(f"step {j}: {', '.join(fam.LOSS_TERMS)}: program {p}, "
             f"reference {r}")
    if window is not None:
        note(f"window's last segment: steps {window['start']} .. "
             f"{window['start'] + window['steps'] - 1}, taken by the "
             f"reference from the program's state")
    return gaps


def window_metrics(run: Run) -> dict:
    """The end-to-end metrics of a training window."""
    return {"train_step_s": run.window_s / run.units}
