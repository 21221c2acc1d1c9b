"""``--compile-ahead``: ready the next pyramid scale's training state while
this scale trains (port of ``hpvaegan_tpu/train/precompile.py``; the
trainer's hooks ``trainer.py:176-189, 346-352``).

The JAX package compiles scale ``s+1``'s programs from abstract shapes on
a daemon thread.  Eager PyTorch compiles nothing, but a scale boundary
on the card pays work of the same kind: the critic and both Adams are
built, the device cache's stores uploaded, and under ``--scan-steps K``
the first step runs eagerly before ``torch.cuda.graph`` captures it.
Here the work for scale ``s+1`` starts once scale ``s``'s first chunk
has returned (its own capture is done):

1. a daemon thread builds the scale's state apart from scale ``s``'s,
   on its own copy of ``cfg`` (``models/remat.py`` reads ``G.cfg`` at
   call time, so the shared one must not move): a generator grown as
   ``init_next_stage`` grows it, the critic reset as the trainer resets
   it (its values kept aside), both Adams (``optim.build_*_optimizer``),
   and on the device cache the loader, whose stores come from
   ``dataset.device_cache_spec`` (the current frames stay scale
   ``s``'s);
2. once it is built, at the next chunk boundary of scale ``s`` (at the
   latest after its last chunk), the main thread runs one warm-up step
   of it on stand-in inputs (the cache's row 0 or zero batches, draws
   from a throwaway generator, zero amps), puts the Adams back to a
   fresh state in place (``optim.reset_adam_``), and on the card under
   ``--scan-steps K > 1`` (the first chunk's k, as the JAX ``_chunk_k``)
   captures the scale's ``StepGraph`` (``StepGraph.prime``), so that the
   scale's first step is a replay.  The amps are the graph's inputs (a
   tensor), because scale ``s+1``'s is calibrated only at the boundary.

Why the warm-up and the capture are not the thread's: on the card a
graph captured on a second thread was not bit-equal to the main path's
in a long process.  Early in a process (a fresh one, the tiny CLI) it
was; after enough other work (the thread's first GAN scale, late in
``chip_smoke.py`` or in the card's test file) the first GAN update's
gradients differed in their last bits, with a thread a scale or one
worker thread, with one warm-up step or two, with cuDNN on or off; run
on the main thread, the same warm-up and capture stayed bit-equal in
every run.  PyTorch keeps per-thread CUDA library state (cuDNN's plan
cache, the cuDNN and cuBLAS handles a thread takes from a pool); which
of it differs was not found.  So the thread does the host work and the
uploads, and the card's work for the step runs where the run's own
steps run.

Scale ``s+1``'s ``train_scale`` joins the thread (``take_ahead``,
``timeout=900`` as in the JAX trainer) before its calibration and adopts
the state: the values of the generator that just finished scale ``s``
and grew (``init_next_stage``) and the critic's init are written into
the ahead tensors in place (``load_state_dict`` copies; a captured graph
holds their addresses), its warm start then loads into them as without
the flag, and the generator comes back from ``train_scale`` for the CLI
to grow further.  The steps, draws and amps are the run's own, so a run
with the flag ends bit-equal to one without it.

The JAX rules kept: nothing ahead past ``stop_scale`` or of the resumed
scale; a failure ahead is a logged warning (``compile-ahead for scale
<s> failed``) and the boundary builds the scale as without the flag.
One difference: an out-of-memory error ahead publishes no rung of the
memory ladder.  JAX's ahead compile holds no device memory, so there an
OOM is the next scale's own; here the ahead state shares the card with
scale ``s``, so what it holds is freed and the boundary's ``Ladder``
chooses the rung as without the flag.  The boundary also
builds afresh when the ladder climbed during scale ``s`` (the graph
ahead was captured on the old rung).

The thread is one worker a process (``compile-ahead``), serving every
scale of every run.

Under a mesh (``--spmd --mesh-shape``) the thread builds the state only:
a warm-up would run the mesh's collectives, whose gloo groups belong to
the main thread (the mesh's chunks run eagerly anyway).

The kernels' launches of the work ahead (in ``prime_ahead``, and on its
graph's streams, where the autograd engine runs the backward) count in
each kernel module's ``ahead_counts`` (``ops/kernels/_counting.py``),
so the main path's counts are the same with and without the flag.
"""
from __future__ import annotations

import copy
import gc
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..data.loader import make_loader
from ..models.registry import make_discriminator, make_generator
from ..ops.kernels import conv3d, conv3d_fuse, conv3d_pack, conv3d_spmd
from ..ops.kernels._counting import counted_apart
from ..parallel.mesh import attach
from .graphs import StepGraph
from .optim import (build_d_optimizer, build_g_optimizer, freeze_frozen,
                    reset_adam_)

__all__ = ["AheadScale", "start_ahead", "prime_ahead", "take_ahead",
           "ahead_launches", "JOIN_TIMEOUT_S"]

JOIN_TIMEOUT_S = 900
_RUNGS = ("remat", "gp_chunked", "remat_blocks")


def _chunk_k(cfg) -> int:
    """The scale's first chunk (the JAX ``_chunk_k``, ``precompile.py:
    77-85``): the scan depth, cut to the first print boundary when
    visualizing.  Above 1 the scale's steps replay a CUDA graph."""
    k = max(1, min(int(getattr(cfg, "scan_steps", 1)), cfg.niter))
    if cfg.visualize and cfg.print_interval > 0:
        k = max(1, min(k, cfg.print_interval))
    return k


def _predicted_n_amps(cfg, scale_idx: int) -> int:
    """``Noise_Amps``' length at ``scale_idx``'s first step (the JAX
    ``_predicted_n_amps``, ``precompile.py:242-248``): one more than now
    unless a resumed run's list already covers it."""
    n = len(cfg.Noise_Amps)
    return n if n >= scale_idx + 1 else scale_idx + 1


def ahead_launches() -> dict:
    """The kernels' launches counted apart so far, by kernel and dtype."""
    cp, cf = conv3d_pack.ahead_counts, conv3d_fuse.ahead_counts
    return {"conv3d64_fwd": cp.fwd_launches, "conv3d64_dx": cp.dx_launches,
            "conv3d64_dw": cp.dw_launches,
            "conv3d64_fwd_bf16": cp.fwd_bf16_launches,
            "conv3d64_dx_bf16": cp.dx_bf16_launches,
            "conv3d64_dw_bf16": cp.dw_bf16_launches,
            "conv3d64_pair": cf.launches,
            "conv3d64_pair_bf16": cf.bf16_launches,
            "conv3d_lrelu": conv3d.ahead_counts.launches,
            "conv3d64_spmd": conv3d_spmd.ahead_counts.launches,
            "conv3d64_spmd_bf16": conv3d_spmd.ahead_counts.bf16_launches,
            "plain": (cp.plain_calls + cf.plain_calls
                      + conv3d.ahead_counts.plain_calls
                      + conv3d_spmd.ahead_counts.plain_calls)}


class AheadScale:
    """Scale ``scale_idx``'s state, readied beside the scale before it:
    ``G``, ``D`` (None in a VAE scale), ``opt_g``, ``opt_d``, ``loader``
    (the device cache; None on ``--host-loader``), the step on its
    stand-in ``inputs`` (None under a mesh), ``graph`` (a primed
    ``StepGraph``, or None), and what it took: ``seconds`` (the
    thread's build), ``prime_seconds`` (the warm-up and capture),
    ``launches`` (by kernel) and the graph's ``pool_bytes``."""

    def __init__(self, scale_idx: int, cfg, G, D, d_init, opt_g, opt_d,
                 loader, graph: Optional[StepGraph]):
        self.scale_idx, self.cfg = scale_idx, cfg
        self.G, self.D, self._d_init = G, D, d_init
        self.opt_g, self.opt_d = opt_g, opt_d
        self.loader, self.graph = loader, graph
        self.step = self.inputs = None
        self.seconds = self.prime_seconds = 0.0
        self.launches: dict = {}

    @property
    def pool_bytes(self) -> int:
        return self.graph.pool_bytes if self.graph is not None else 0

    @torch.no_grad()
    def adopt(self, G, cfg) -> None:
        """Take the run's values over, in place: ``G``'s (the generator
        that finished the previous scale and grew) and the critic's init;
        the trainer then warm-starts the critic into ``self.D``."""
        self.G.load_state_dict(G.state_dict())
        self.G.cfg = cfg
        if self.D is not None:
            self.D.load_state_dict(self._d_init)
        self._d_init = None

    def info(self) -> dict:
        """The ``"ahead"`` callback event's numbers."""
        return {"seconds": self.seconds,
                "prime_seconds": self.prime_seconds,
                "captured": int(self.graph is not None),
                "graph_pool_bytes": self.pool_bytes,
                "launches": sum(v for k, v in self.launches.items()
                                if k != "plain")}

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
        self.graph = self.loader = self.step = self.inputs = None


class _Handle:
    """One scale's job on the worker, and what it left."""

    def __init__(self, scale_idx: int):
        self.scale_idx = scale_idx
        self.state: Optional[AheadScale] = None
        self.done = threading.Event()
        self.primed = False

    def __deepcopy__(self, memo):
        # a copy of the config (or of a module holding it) owns no thread
        return None

    def join(self, timeout: float = JOIN_TIMEOUT_S
             ) -> Optional[AheadScale]:
        if not self.done.wait(timeout):
            logging.warning(f"compile-ahead for scale {self.scale_idx} "
                            f"failed (training unaffected): not ready "
                            f"after {timeout:g} s")
            return None
        return self.state


def _stand_in(cfg, G, gan: bool, loader, scale_idx: int, n_amps: int,
              dev) -> dict:
    """Inputs of the scale's step, of the real ones' shapes: the cache's
    row 0, or zero batches; draws from a throwaway generator; zero amps."""
    from .trainer import iteration_inputs
    b = cfg.batch_size
    if loader is not None:
        source = dict(zip(("idx", "flip"), loader.rows(
            np.zeros(b, np.int64), np.zeros(b, bool))))
        real_zero = loader.gather(source["idx"], source["flip"])[1]
    else:
        real_zero = torch.zeros((b, *G._shape(0), cfg.nc_im), device=dev)
        source = {"real": torch.zeros((b, *G._shape(scale_idx),
                                       cfg.nc_im), device=dev),
                  "real_zero": real_zero}
    amps = torch.zeros(n_amps, dtype=torch.float32, device=dev)
    return iteration_inputs(cfg, G, gan, source, tuple(real_zero.shape),
                            amps, torch.Generator(device=dev).manual_seed(0))


def _build(cfg, pyramid, ndim: int, n_body: int, mesh, dev, dataset,
           scale_idx: int, seed: int, n_amps: int) -> AheadScale:
    from .trainer import scale_step
    gan = cfg.vae_levels < scale_idx + 1
    G = make_generator(cfg.generator, cfg, pyramid, ndim=ndim)
    G.init(torch.Generator().manual_seed(0)).to(dev)
    attach(G, mesh)
    growth = torch.Generator(device=dev).manual_seed(0)
    for _ in range(n_body + 1):
        G.init_next_stage(growth)
    D = d_init = opt_d = None
    if gan:
        D = make_discriminator(cfg.discriminator, cfg, ndim)
        D.reset_parameters(torch.Generator().manual_seed(
            seed * 1000 + 101 + scale_idx))
        D.to(dev)
        attach(D, mesh)
        d_init = {k: v.clone() for k, v in D.state_dict().items()}
        opt_d = build_d_optimizer(cfg, D)
    opt_g = build_g_optimizer(cfg, G, scale_idx)
    if cfg.fast_grads:
        freeze_frozen(cfg, G, scale_idx)
    loader = None
    if not cfg.host_loader:
        loader = make_loader(dataset, cfg, seed, scale_idx, dev,
                             views=dataset.device_cache_spec(scale_idx))
    state = AheadScale(scale_idx, cfg, G, D, d_init, opt_g, opt_d, loader,
                       None)
    if mesh is None:   # a step would run the mesh's collectives
        state.step = scale_step(cfg, G, D, opt_g, opt_d, loader, gan)
        state.inputs = _stand_in(cfg, G, gan, loader, scale_idx, n_amps,
                                 dev)
    if dev.type == "cuda":
        # the state's tensors are whole before the main thread reads them
        torch.cuda.current_stream(dev).synchronize()
    return state


def _run(handle: _Handle, cfg, args: tuple) -> None:
    s = handle.scale_idx
    t0 = time.perf_counter()
    oom = None
    try:
        with counted_apart():
            state = _build(cfg, *args)
        state.seconds = time.perf_counter() - t0
        if state.step is None:
            logging.info(f"compile-ahead scale {s}: state built, ready in "
                         f"{state.seconds:.1f}s")
        handle.state = state
    except torch.OutOfMemoryError as e:
        oom = repr(e)
    except Exception as e:  # a speculative build never stops training
        logging.warning(f"compile-ahead for scale {s} failed (training "
                        f"unaffected): {e!r}")
    if oom is not None:
        _failed_oom(s, oom)


def _failed_oom(s: int, oom: str) -> None:
    # called out of the handler: its frames, and the tensors they held,
    # are gone; no rung is published (the boundary's ladder decides)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    logging.warning(f"compile-ahead for scale {s} failed (training "
                    f"unaffected; out of device memory beside scale "
                    f"{s - 1}, so no rung of the memory ladder is taken "
                    f"ahead): {oom}")


def _prime(state: AheadScale) -> None:
    """The warm-up, the reset and (on the card, under ``--scan-steps K >
    1``) the capture, on the calling (main) thread."""
    opts = [o for o in (state.opt_g, state.opt_d) if o is not None]

    def reset():
        for opt in opts:
            reset_adam_(opt)

    dev = state.G.device
    if dev.type != "cuda":
        with counted_apart():
            state.step(state.inputs)
            reset()
        return
    graph = StepGraph(state.step, dev, modules=[
        m for m in (state.G, state.D) if m is not None])
    with counted_apart(graph.streams):
        graph.prime(state.inputs, reset, capture=_chunk_k(state.cfg) > 1)
    if graph.captured:
        state.graph = graph


def prime_ahead(cfg, wait: bool = False) -> None:
    """Warm up (and capture) the state the thread built, on this (the
    main) thread, once it is built: now if it is, or after waiting for
    it (``wait``, a scale's end).  Each launch here counts apart."""
    handle = getattr(cfg, "_ahead", None)
    if handle is None or handle.primed or \
            not (handle.done.is_set() or wait):
        return
    state = handle.join()
    handle.primed = True
    if state is None or state.step is None:
        return
    s = handle.scale_idx
    t0 = time.perf_counter()
    before = ahead_launches()
    oom = None
    try:
        _prime(state)
    except torch.OutOfMemoryError as e:
        oom = repr(e)
    except Exception as e:  # never let the work ahead stop training
        logging.warning(f"compile-ahead for scale {s} failed (training "
                        f"unaffected): {e!r}")
        handle.state = None
        state.close()
        return
    if oom is not None:
        handle.state = None
        state.close()
        del state
        _failed_oom(s, oom)
        return
    state.prime_seconds = time.perf_counter() - t0
    now = ahead_launches()
    state.launches = {k: now[k] - before[k] for k in now}
    captured = (f", step graph captured ({state.pool_bytes} bytes)"
                if state.graph is not None else "")
    logging.info(f"compile-ahead scale {s}: state built in "
                 f"{state.seconds:.1f}s, warmed up{captured}, ready in "
                 f"{state.seconds + state.prime_seconds:.1f}s")


_jobs: "queue.Queue" = queue.Queue()
_worker: Optional[threading.Thread] = None
_worker_lock = threading.Lock()


def _work() -> None:
    while True:
        handle, cfg, args = _jobs.get()
        try:
            _run(handle, cfg, args)
        finally:
            handle.done.set()


def _submit(handle: _Handle, cfg, args: tuple) -> None:
    """Queue a job on the process's worker, started at the first job."""
    global _worker
    with _worker_lock:
        if _worker is None or not _worker.is_alive():
            _worker = threading.Thread(target=_work, daemon=True,
                                       name="compile-ahead")
            _worker.start()
    _jobs.put((handle, cfg, args))


def start_ahead(cfg, G, dataset, scale_idx: int, seed: int) -> None:
    """Start readying ``scale_idx`` on the worker thread, unless it is past
    ``stop_scale`` or the resumed scale; ``take_ahead`` at that scale's
    start joins it.  ``G`` is the generator training now (its structure
    is read here, on the calling thread)."""
    if scale_idx > cfg.stop_scale or cfg.resumed_idx == scale_idx:
        return
    mesh = G.mesh
    if mesh is not None and not getattr(cfg, "_ahead_mesh_noted", False):
        cfg._ahead_mesh_noted = True
        logging.info("--compile-ahead under a mesh: the next scale's state "
                     "is built ahead and not warmed up (a step would run "
                     "the mesh's collectives, whose groups are the main "
                     "thread's)")
    own = copy.copy(cfg)
    own._ahead = None
    own.scale_idx = scale_idx
    own.Noise_Amps = list(cfg.Noise_Amps)
    handle = _Handle(scale_idx)
    args = (G.pyramid, G.ndim, len(G.body), mesh, G.device, dataset,
            scale_idx, seed, _predicted_n_amps(cfg, scale_idx))
    cfg._ahead = handle
    _submit(handle, own, args)


def take_ahead(cfg, scale_idx: int, G) -> Optional[AheadScale]:
    """Join the thread readying ``scale_idx`` and adopt its state with
    ``G``'s values (``AheadScale.adopt``); None when there is none to
    take (the scale is then built as without the flag)."""
    prime_ahead(cfg, wait=True)
    handle = getattr(cfg, "_ahead", None)
    cfg._ahead = None
    if handle is None:
        return None
    state = handle.join()
    if state is None:
        return None
    if handle.scale_idx != scale_idx or any(
            getattr(state.cfg, r) != getattr(cfg, r) for r in _RUNGS):
        logging.info(f"compile-ahead scale {handle.scale_idx}: the memory "
                     f"ladder climbed since it started; scale {scale_idx} "
                     f"is built at the boundary")
        state.close()
        return None
    state.adopt(G, cfg)
    return state
