"""The port's spans (``utils/profiling.span``) on the CPU.

With no profiler recording, ``span`` is one shared no-op context and
builds no ``record_function``.  Under ``torch.profiler`` (``start()``
sets the flag ``span`` reads) a tiny ``gan_step`` and tiny
``SamplerSession`` requests export the spans as ``user_annotation``
events, nested as the layers are: the GAN step's spectral update, critic
half (penalty, backward, Adam) and generator half (backward, Adam); a
request's forward and host copy; one ``gen.stage.<i>`` a pyramid stage
and forward.  ``train_scale`` adds ``train.chunk``, ``train.inputs`` and
``train.callback`` and ends with the same weights, bit for bit, whether a
profiler records or not."""
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import torch_port_fast as fast
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                make_generator)
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.train import optim, steps, trainer
from hpvaegan_tpu_torch.utils import profiling
from hpvaegan_tpu_torch.utils.profiling import span
from hpvaegan_tpu_torch.utils.saver import save_generator
from torch_port_runs import REPO, make_clip, one_torch_thread, port_run

SCALE = 3   # three refinement stages after the decoder's level 0
STAGES = [f"gen.stage.{i}" for i in range(SCALE)]
# the package's spans, apart from torch's own (``Optimizer.step#...``)
PACKAGE = ("serve", "gen", "train", "graph", "step")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _models(**over):
    cfg = fast.cfg_of(Config, **over)
    cfg.scale_idx = SCALE
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(SCALE):
        G.init_next_stage(gen)
    G.requires_grad_(True)
    D = make_discriminator("WDiscriminator3D", cfg, 3)
    D.reset_parameters(torch.Generator().manual_seed(1))
    return cfg, G, D, pyr


class _Span:
    def __init__(self, event):
        self.name = event["name"]
        self.tid = event["tid"]
        self.start = float(event["ts"])
        self.end = self.start + float(event["dur"])
        self.parent = None

    def within(self, other) -> bool:
        return (self.tid == other.tid and other.start <= self.start
                and self.end <= other.end)


def _recorded(fn, tmp_path):
    """``fn()`` under a CPU profiler; returns its result and the package's
    exported ``user_annotation`` spans, each with its innermost enclosing
    one on its thread as ``parent``."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [_Span(e) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"].split(".")[0] in PACKAGE]
    spans.sort(key=lambda s: (s.start, -s.end))
    for i, s in enumerate(spans):
        for outer in reversed(spans[:i]):
            if s.within(outer):
                s.parent = outer
                break
    return out, spans


def _parents(spans, name):
    return Counter(s.parent.name if s.parent else None
                   for s in spans if s.name == name)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    first, second = span("serve.request"), span(f"gen.stage.{3}")
    assert first is second is profiling._NO_SPAN
    with first:
        with second:
            pass


def test_a_started_profiler_sets_the_flag_span_reads():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        recording = span("train.chunk")
        assert isinstance(recording, autograd_profiler.record_function)
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    assert span("train.chunk") is profiling._NO_SPAN


@pytest.mark.parametrize("over", [{}, {"fused_forwards": True}],
                         ids=["split", "fused"])
def test_gan_step_spans_nest_as_the_step(over, tmp_path):
    cfg, G, D, pyr = _models(**over)
    opt_g = optim.build_g_optimizer(cfg, G, SCALE)
    opt_d = optim.build_d_optimizer(cfg, D)
    real, real_zero, noise_init = fast.data(pyr, 3, SCALE, 5)
    _, spans = _recorded(lambda: steps.gan_step(
        G, D, opt_g, opt_d, cfg, real, real_zero, noise_init, fast.AMPS,
        generator=torch.Generator().manual_seed(3)), tmp_path)
    top = {"step.spectral", "step.critic", "step.generator"}
    for name in top:
        assert _parents(spans, name) == Counter({None: 1}), name
    for child in ("penalty", "backward", "update"):
        assert _parents(spans, f"step.critic.{child}") == \
            Counter({"step.critic": 1})
    for child in ("backward", "update"):
        assert _parents(spans, f"step.generator.{child}") == \
            Counter({"step.generator": 1})
    order = [s.name for s in spans if s.name in top]
    assert order == ["step.spectral", "step.critic", "step.generator"]
    # the critic half's fake forward, the generator half's rec and rand
    # forwards (one fused forward under --fused-forwards)
    per_half = 1 if over else 2
    for name in STAGES:
        assert _parents(spans, name) == Counter(
            {"step.critic": 1, "step.generator": per_half}), name
    assert {s.name for s in spans} == top | set(STAGES) | {
        "step.critic.penalty", "step.critic.backward", "step.critic.update",
        "step.generator.backward", "step.generator.update"}


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A CPU session on a tiny scale-3 generator, its checkpoint and
    ``config.json`` written as training writes them."""
    d = tmp_path_factory.mktemp("session")
    cfg, G, _, _ = _models()
    cfg.video_path = os.path.join(REPO, "data", "vids", "wingsuit.avi")
    netG = str(d / "netG")
    save_generator(netG, G, SCALE, fast.AMPS)
    (d / "config.json").write_text(json.dumps(cfg.snapshot_dict()))
    scfg = Config(netG=netG)
    apply_snapshot(scfg, netG, explicit=set(), user_chose_source=False)
    scfg.adjust_scales()
    return SamplerSession(scfg, batch_size=fast.BATCH, device="cpu")


def _request(session, mode):
    g = torch.Generator().manual_seed(11)
    if mode == "rand":
        return session.sample_batch(g)
    t0, h0, w0 = session.train_pyramid.shape3d(0)
    if mode == "rec":
        return session.reconstruct_batch(
            np.zeros((t0, h0, w0, 3), np.float32), g)
    start = 1
    x = np.zeros((fast.BATCH, *session.pyramid.shape3d(start), 3),
                 np.float32)
    return session.inject_batch(x, start, g)


@pytest.mark.parametrize("mode", ["rand", "rec", "inject"])
def test_a_request_spans_its_forward_and_host_copy(session, mode, tmp_path):
    out, spans = _recorded(lambda: _request(session, mode), tmp_path)
    assert isinstance(out, np.ndarray)
    assert _parents(spans, "serve.request") == Counter({None: 1})
    for name in ("serve.forward", "serve.host"):
        assert _parents(spans, name) == Counter({"serve.request": 1}), name
    forward, host = (next(s for s in spans if s.name == n)
                     for n in ("serve.forward", "serve.host"))
    assert forward.end <= host.start
    first = 1 if mode == "inject" else 0   # inject refines from stage 1
    stages = [s.name for s in spans if s.name.startswith("gen.stage.")]
    assert stages == STAGES[first:]
    for name in stages:
        assert _parents(spans, name) == Counter({"serve.forward": 1})


def _batches(pyr, seed):
    rng = np.random.default_rng(seed)
    while True:
        yield (np.tanh(rng.standard_normal(
            (fast.BATCH, *pyr.shape3d(SCALE), 3))).astype(np.float32),
               np.tanh(rng.standard_normal(
                   (fast.BATCH, *pyr.shape3d(0), 3))).astype(np.float32))


def _train(scan_steps, events):
    cfg, G, D_prev, pyr = _models(niter=3, scan_steps=scan_steps)
    cfg.Noise_Amps = [1.0, 0.3, 0.2]
    G, D, _ = trainer.train_scale(
        cfg, G, _batches(pyr, 3), D_prev=D_prev, seed=5,
        callback=lambda event, it, info: events.append(event))
    return G, D


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_train_scale_ends_bit_equal_with_a_profiler_recording(scan_steps,
                                                              tmp_path):
    plain_events, traced_events = [], []
    G0, D0 = _train(scan_steps, plain_events)
    (G1, D1), spans = _recorded(lambda: _train(scan_steps, traced_events),
                                tmp_path)
    assert plain_events == traced_events
    for a, b in ((G0, G1), (D0, D1)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k, v in sa.items():
            assert torch.equal(v, sb[k]), k
    chunks = 3 if scan_steps == 1 else 2   # chunks of 2 and 1
    assert _parents(spans, "train.chunk") == Counter({None: chunks})
    assert _parents(spans, "train.inputs") == Counter({"train.chunk": 3})
    assert _parents(spans, "train.callback") == Counter(
        {None: len(traced_events)})
    assert _parents(spans, "step.critic") == Counter({"train.chunk": 3})


def test_the_profile_dir_trace_carries_the_spans(tmp_path):
    """``--profile-dir``'s Chrome trace of a scale holds the trainer's
    spans, and a GAN scale's the step's halves."""
    prof = tmp_path / "prof"
    port_run(make_clip(tmp_path), tmp_path / "run", "--niter", "6",
             "--profile-dir", str(prof))
    names = {}
    for d in sorted(os.listdir(prof)):
        with open(prof / d / "trace.json") as f:
            names[d] = {e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation"}
    vae, gan = names["scale_0"], names[max(names)]
    # scale 0 is the decoder alone: no refinement stage
    assert {"train.chunk", "train.inputs"} <= vae
    assert not any(n.startswith("step.") for n in vae)
    assert {"train.chunk", "train.inputs", "gen.stage.0", "step.spectral",
            "step.critic", "step.critic.penalty", "step.generator",
            "step.generator.update"} <= gan
