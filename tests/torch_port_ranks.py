"""Rank programs for the tests of the port's sharded path: groups of gloo
CPU ranks, each rank a fresh interpreter that imports torch and the port
only (never JAX).

    python tests/torch_port_ranks.py <programs> <rank> <world> <port> <dir>

runs each of the comma-separated ``PROGRAMS[program](mesh_shapes, dir)``
as rank ``rank`` of ``world`` and writes their results, one dict, to
``<dir>/<programs>_<world>_<rank>.pt``.
The test process writes the inputs into ``dir`` first (``inputs.pt``) and
holds the results against JAX.  ``start_ranks`` starts a group and
``wait_ranks`` waits for it with a time limit, so a mismatched
collective fails instead of hanging.

    python tests/torch_port_ranks.py serve <rank> <world> <port> \
        <timeout_s> <serve args...>

runs one rank of ``cli.serve`` over a group with a shortened timeout.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(program: str, world: int, workdir) -> list:
    """Start the ``world`` ranks of ``program`` (one intra-op thread
    each); returns the processes."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), program, str(rank),
         str(world), port, str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def wait_ranks(procs, timeout: float = TIMEOUT_S) -> None:
    """Wait for every rank; kill them all and raise with every rank's
    output if one fails or the group outlives ``timeout``."""
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed = True
        outs.append(out)
        failed = failed or p.returncode != 0
    if failed:
        raise RuntimeError("\n".join(f"--- rank {i} (code {p.returncode}):\n"
                                     f"{o}" for i, (p, o) in
                                     enumerate(zip(procs, outs))))


def results(program: str, world: int, workdir) -> list:
    import torch
    return [torch.load(os.path.join(str(workdir),
                                    f"{program}_{world}_{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def record_grads(opt, module, into: dict):
    """``opt`` whose ``step`` first copies the gradients it is about to
    apply into ``into``, by parameter name of ``module``."""
    names = {id(p): n for n, p in module.named_parameters()}
    step = opt.step

    def recorded(*a, **kw):
        into.update({names[id(p)]: p.grad.clone()
                     for group in opt.param_groups
                     for p in group["params"] if p.grad is not None})
        return step(*a, **kw)
    opt.step = recorded
    return opt


# ---------------------------------------------------------------------------
# the programs (run inside a rank)
# ---------------------------------------------------------------------------

def program_k4(meshes, workdir):
    """K4 (``conv3d64_spmd``, and its plain twin) forward and gradients of
    ``sum(y * cos(y))`` on each mesh, for every input of ``inputs.pt``."""
    import torch
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    from hpvaegan_tpu_torch.parallel import make_mesh
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape)
        for name, (x, w, b) in inputs["k4"].items():
            for fn in (k4.conv3d64_spmd, k4.conv3d64_spmd_plain):
                xl = mesh.shard(x, 2).requires_grad_(True)
                wl, bl = w.clone().requires_grad_(True), \
                    b.clone().requires_grad_(True)
                k4.counts.reset()
                y = fn(xl, wl, bl, mesh)
                (y * torch.cos(y)).sum().backward()
                out[(shape, name, fn.__name__)] = dict(
                    y=y.detach(), dx=xl.grad, dw=wl.grad, db=bl.grad,
                    plain_calls=k4.counts.plain_calls,
                    block=mesh.block(x.shape[2]),
                    rows=mesh.batch_rows(x.shape[0]))
    return out


def program_k4gp(meshes, workdir):
    """The WGAN-GP-style second order through K4 (chip_smoke's
    ``penalty_grads`` of ``conv3d64_spmd``) on each mesh: this rank's dx
    block, its shares of dw and db, and K1's calls."""
    import torch
    from chip_smoke import penalty_grads
    from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    from hpvaegan_tpu_torch.parallel import make_mesh
    x, w, b = torch.load(os.path.join(workdir, "inputs.pt"))["k4gp"]
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape)
        xl = mesh.shard(x, 2).requires_grad_(True)
        wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        cp.counts.reset()
        k4.counts.reset()
        dx, dw, db = penalty_grads(
            lambda x, w, b: k4.conv3d64_spmd(x, w, b, mesh), xl, wl, bl,
            (xl, wl, bl))
        out[(shape, "k4gp")] = dict(
            dx=dx, dw=dw, db=db, k1_calls=cp.counts.plain_calls,
            k4_calls=k4.counts.plain_calls, block=mesh.block(x.shape[2]),
            rows=mesh.batch_rows(x.shape[0]))
    return out


def program_halo(meshes, workdir):
    """The halo exchange in float64: ``<E x, y>`` and ``<x, E^T y>`` over
    the mesh, and ``gradgradcheck`` through a haloed stock conv."""
    import torch
    from hpvaegan_tpu_torch.models.blocks import _stock_conv
    from hpvaegan_tpu_torch.ops.kernels.conv3d_spmd import halo
    from hpvaegan_tpu_torch.parallel import make_mesh
    from hpvaegan_tpu_torch.parallel.distributed import all_reduce_
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape)
        if mesh.n_spatial == 1:
            continue
        g = torch.Generator().manual_seed(100 + mesh.rank)
        for h_whole in (7, 9):
            h0, h1 = mesh.block(h_whole)
            x = torch.randn((2, 3, h1 - h0, 4, 5), dtype=torch.float64,
                            generator=g, requires_grad=True)
            y = torch.randn((2, 3, h1 - h0 + 2, 4, 5), dtype=torch.float64,
                            generator=g)
            ex = halo(x, mesh, 2)
            (ety,) = torch.autograd.grad((ex * y).sum(), x)
            sums = torch.stack([(ex * y).sum(), (x * ety).sum()]).detach()
            out[(shape, h_whole, "adjoint")] = all_reduce_(sums)

        # gradgradcheck on one live rank at a time: the other ranks feed
        # constant rows and weigh their own output by 0, so the live
        # rank's numerical derivatives see all that its analytical ones do
        for live in range(mesh.n_spatial):
            gen = torch.Generator().manual_seed(7)
            w = torch.randn((1, 1, 3, 3, 3), dtype=torch.float64,
                            generator=gen, requires_grad=True)
            x = torch.randn((1, 1, 2, 2, 3), dtype=torch.float64,
                            generator=gen, requires_grad=True)
            const = torch.randn((1, 1, 2, 2, 3), dtype=torch.float64,
                                generator=gen)
            weight = 1.0 if mesh.spatial_index == live else 0.0

            def f(x, w):
                xin = x if weight else const + 0.0 * x
                y = _stock_conv(xin, w, torch.zeros(1, dtype=w.dtype), 3, 1,
                                1, None, mesh)
                return weight * y

            out[(shape, "gradgradcheck", live)] = \
                torch.autograd.gradgradcheck(f, (x, w))
    return out


def program_steps(meshes, workdir):
    """``vae_step`` and ``gan_step`` on each mesh from the inputs' weights
    and draws: metrics, the gradients that reach Adam (summed over the
    mesh), the parameters after the step, K4's calls."""
    import torch
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.models.networks import WDiscriminator
    from hpvaegan_tpu_torch.models.registry import make_generator
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    from hpvaegan_tpu_torch.parallel import attach, make_mesh
    from hpvaegan_tpu_torch.parallel.mesh import state_digest
    from hpvaegan_tpu_torch.train import optim, steps
    inp = torch.load(os.path.join(workdir, "inputs.pt"),
                     weights_only=False)

    def generator(scale):
        cfg = Config(**inp["cfg"])
        cfg.ar, cfg.org_fps = inp["ar"], inp["org_fps"]
        cfg.adjust_scales()
        cfg.scale_idx = scale
        G = make_generator("GeneratorHPVAEGAN", cfg, cfg.pyramid(), ndim=3)
        G.init(torch.Generator().manual_seed(0))
        for _ in range(scale):
            G.init_next_stage()
        G.load_state_dict(inp[f"G{scale}"])
        return cfg, G.requires_grad_(True)

    out = {}
    for shape in meshes:
        mesh = make_mesh(shape)
        k4.counts.reset()
        scale = inp["vae_scale"]
        cfg, G = generator(scale)
        attach(G, mesh)
        grads = {}
        opt_g = record_grads(optim.build_g_optimizer(cfg, G, scale), G,
                             grads)
        metrics = steps.vae_step(G, opt_g, cfg, *inp["vae_data"],
                                 inp["vae_amps"], eps=inp["vae_eps"])
        out[(shape, "vae")] = dict(
            metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
            state=G.state_dict(), digest=state_digest(G),
            k4_calls=k4.counts.plain_calls)

        k4.counts.reset()
        scale = inp["gan_scale"]
        cfg, G = generator(scale)
        D = WDiscriminator(3, 64, 3, cfg.num_layer, ndim=3, pconv=True)
        D.load_state_dict(inp["D"])
        attach(G, mesh)
        attach(D, mesh)
        g_grads, d_grads = {}, {}
        opt_g = record_grads(optim.build_g_optimizer(cfg, G, scale), G,
                             g_grads)
        opt_d = record_grads(optim.build_d_optimizer(cfg, D), D, d_grads)
        real, real_zero, noise_init = inp["gan_data"]
        metrics = steps.gan_step(G, D, opt_g, opt_d, cfg, real, real_zero,
                                 noise_init, inp["gan_amps"],
                                 noises=inp["gan_noises"],
                                 eps=inp["gan_eps"], alpha=inp["gan_alpha"])
        out[(shape, "gan")] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=g_grads, d_grads=d_grads, state=G.state_dict(),
            d_state=D.state_dict(),
            digest=torch.cat([state_digest(G), state_digest(D)]),
            k4_calls=k4.counts.plain_calls)
    return out


def run_model_case(case: dict, mesh=None) -> dict:
    """One training step of ``case`` (a dict of the models' config
    overrides, weights, data and draws; see
    tests/test_torch_port_mesh_models.py) on ``mesh`` (None: one
    process): ``vae`` and ``gan`` run ``vae_step``/``gan_step``,
    ``baseline`` runs ``baseline_step``.  Returns the metrics, the
    gradients that reach Adam, the states after the step and the ranks'
    parameter digest; for ``vae``, first an eval-mode rec forward drawing
    from a generator of seed 7 (``evaluated``, whole).  A case with
    ``wpack_min_w`` sets ``models.packed.WPACK_MIN_W`` to it first."""
    import torch
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.models import packed
    from hpvaegan_tpu_torch.models.registry import (make_discriminator,
                                                    make_generator)
    from hpvaegan_tpu_torch.parallel import attach
    from hpvaegan_tpu_torch.parallel.mesh import state_digest
    from hpvaegan_tpu_torch.train import optim, steps

    if "wpack_min_w" in case:
        packed.WPACK_MIN_W = case["wpack_min_w"]
    cfg = Config(**case["cfg"])
    cfg.ar, cfg.org_fps = case["ar"], case["org_fps"]
    cfg.adjust_scales()
    cfg.scale_idx = scale = case["scale"]
    G = make_generator(cfg.generator, cfg, cfg.pyramid(), ndim=3)
    G.init(torch.Generator().manual_seed(0))
    while len(G.body) < case["stages"]:
        G.init_next_stage()
    G.load_state_dict(case["G"])
    attach(G.requires_grad_(True), mesh)
    g_grads, d_grads = {}, {}
    opt_g = record_grads(optim.build_g_optimizer(cfg, G, scale), G, g_grads)
    evaluated = None
    if case["step"] == "vae":   # an eval-mode rec forward on its own draws
        with torch.no_grad():
            out, _, _ = G.apply(case["amps"], real_zero=case["data"][1],
                                mode="rec", train=False,
                                generator=torch.Generator().manual_seed(7))
            evaluated = out if mesh is None else mesh.gather_whole(out, 2)
    D = None
    if case["step"] != "vae":
        D = make_discriminator(cfg.discriminator, cfg, 3)
        D.load_state_dict(case["D"])
        attach(D, mesh)
        opt_d = record_grads(optim.build_d_optimizer(cfg, D), D, d_grads)
    if case["step"] == "vae":
        metrics = steps.vae_step(G, opt_g, cfg, *case["data"], case["amps"],
                                 eps=case["eps"])
    elif case["step"] == "gan":
        metrics = steps.gan_step(G, D, opt_g, opt_d, cfg, *case["data"],
                                 case["amps"], noises=case["noises"],
                                 eps=case["eps"], alpha=case["alpha"],
                                 latents=case["latents"])
    else:
        metrics = steps.baseline_step(G, D, opt_g, opt_d, cfg, *case["data"],
                                      case["amps"], noises=case["noises"],
                                      alphas=case["alphas"])
    modules = [G] if D is None else [G, D]
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                evaluated=evaluated,
                grads=g_grads, d_grads=d_grads, state=G.state_dict(),
                d_state={} if D is None else D.state_dict(),
                digest=torch.cat([state_digest(m) for m in modules]))


def program_models(meshes, workdir):
    """Every case of ``models.pt`` (``run_model_case``) on each mesh."""
    import torch
    from hpvaegan_tpu_torch.parallel import make_mesh
    cases = torch.load(os.path.join(workdir, "models.pt"),
                       weights_only=False)
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape)
        for name, case in cases.items():
            out[(shape, name)] = run_model_case(case, mesh)
    return out


def port_session(netG: str, **kw):
    """The port's ``SamplerSession`` of the experiment ``netG`` on the
    CPU, configured from its snapshot as the CLIs do (batch 2, seed 3
    unless ``kw`` says otherwise)."""
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
    cfg = Config(netG=netG)
    apply_snapshot(cfg, netG, explicit=set(), user_chose_source=False)
    cfg.adjust_scales()
    kw = {"batch_size": 2, "manual_seed": 3, **kw}
    return SamplerSession(cfg, device="cpu", **kw)


def session_calls(sess, calls) -> list:
    """Each ``(mode, kwargs)`` of ``calls`` on ``sess``: ``rand``,
    ``rec`` or ``inject`` batches."""
    fns = {"rand": sess.sample_batch, "rec": sess.reconstruct_batch,
           "inject": sess.inject_batch}
    return [fns[mode](**kw) for mode, kw in calls]


def program_sampling(meshes, workdir):
    """Every case of ``sampling.pt`` (an experiment, the session's
    arguments and its calls) through ``SamplerSession(mesh_shape=...)``
    on each mesh: the calls' outputs, K4's calls, and, on a mesh with a
    data axis, the error of a batch that axis does not divide."""
    import torch
    from hpvaegan_tpu_torch.ops.kernels import conv3d_spmd as k4
    cases = torch.load(os.path.join(workdir, "sampling.pt"),
                       weights_only=False)
    out = {}
    for shape in meshes:
        spec = "x".join(str(n) for n in shape)
        for name, case in cases.items():
            k4.counts.reset()
            sess = port_session(case["netG"], mesh_shape=spec,
                                **case["session"])
            out[(shape, name)] = dict(
                outs=session_calls(sess, case["calls"]),
                k4=k4.counts.plain_calls,
                block=sess.mesh.block(sess.pyramid.shape2d(sess.scale)[0]))
        if shape[0] > 1:
            try:
                port_session(next(iter(cases.values()))["netG"],
                             mesh_shape=spec, batch_size=3)
            except ValueError as e:
                out[(shape, "odd_batch")] = str(e)
    return out


def _ladder_run(mesh, oom_ranks, remat=False):
    """``train_scale`` in memory on ``mesh`` (3 GAN iterations of a tiny
    model, the critic on the mesh too); on the ranks in ``oom_ranks`` the
    second step raises an OOM once, after it ran."""
    import numpy as np
    import torch
    from hpvaegan_tpu_torch.core.config import Config
    from hpvaegan_tpu_torch.models.registry import make_generator
    from hpvaegan_tpu_torch.parallel import attach
    from hpvaegan_tpu_torch.train import steps, trainer

    cfg = Config(img_size=16, min_size=8, max_size=16, nfc=8, latent_dim=8,
                 num_layer=2, enc_blocks=1, vae_levels=2, niter=3,
                 remat=remat)
    cfg.ar, cfg.org_fps = 0.5625, 24.0
    cfg.adjust_scales()
    cfg.scale_idx, cfg.Noise_Amps = 2, [1.0, 0.3]
    pyr = cfg.pyramid()
    G = make_generator("GeneratorHPVAEGAN", cfg, pyr, ndim=3)
    gen = torch.Generator().manual_seed(0)
    G.init(gen)
    for _ in range(2):
        G.init_next_stage(gen)
    attach(G, mesh)
    calls = [0]

    def gan_step(*args, **kwargs):
        out = steps.gan_step(*args, **kwargs)
        calls[0] += 1
        if calls[0] == 2 and torch.distributed.get_rank() in oom_ranks:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return out

    def batches():
        rng = np.random.default_rng(3)
        while True:
            yield tuple(np.tanh(rng.standard_normal(
                (2, *pyr.shape3d(s), 3))).astype(np.float32) for s in (2, 0))

    trainer.gan_step = gan_step
    try:
        G, D, _ = trainer.train_scale(cfg, G, batches(), seed=5)
    finally:
        trainer.gan_step = steps.gan_step
    return cfg, G, D


def program_ladder_both(meshes, workdir):
    """Both ranks of a 1x2 mesh run out of memory in the same step: both
    escalate to --remat and end as the run with --remat from the
    start."""
    from hpvaegan_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, 2))
    _, G_r, D_r = _ladder_run(mesh, (), remat=True)
    cfg, G, D = _ladder_run(mesh, (0, 1))
    return {"rungs": (cfg.remat, cfg.gp_chunked, cfg.remat_blocks),
            "state": {**G.state_dict(), **D.state_dict()},
            "ref": {**G_r.state_dict(), **D_r.state_dict()}}


def program_ladder_one(meshes, workdir):
    """Rank 1 alone runs out of memory: the agreement times out there and
    the run fails on both ranks."""
    from hpvaegan_tpu_torch.parallel import make_mesh
    from hpvaegan_tpu_torch.train import fallback
    fallback.AGREE_TIMEOUT_S = 5.0
    _ladder_run(make_mesh((1, 2)), (1,))
    return {}


# (isend and irecv run through batch_isend_irecv, whose P2POp takes the
# functions themselves)
_COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "barrier",
                "batch_isend_irecv", "send", "recv",
                "broadcast_object_list", "all_gather_object", "gather",
                "scatter", "reduce", "reduce_scatter", "all_to_all")


def program_ahead_mesh(meshes, workdir):
    """``cli.train_video`` on the tiny config over a 1x2 mesh, without
    and with ``--compile-ahead`` (the clip ``test_video.avi`` in
    ``workdir``): the names of the threads that ran a collective, their
    count, and both runs' final generator weights."""
    import threading

    import torch
    import torch.distributed as dist
    from hpvaegan_tpu_torch.cli import train_video
    from hpvaegan_tpu_torch.utils.logger import kept_logging
    from torch_port_runs import TINY

    threads, calls = set(), [0]

    def recorded(fn):
        def call(*args, **kwargs):
            threads.add(threading.current_thread().name)
            calls[0] += 1
            return fn(*args, **kwargs)
        return call

    for name in _COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, recorded(getattr(dist, name)))
    out = {}
    for tag, extra in (("plain", []), ("ahead", ["--compile-ahead"])):
        with kept_logging():
            train_video.main(["--video-path",
                              os.path.join(str(workdir), "test_video.avi"),
                              *TINY, "--spmd", "--mesh-shape", "1x2",
                              "--distributed", "--run-dir",
                              os.path.join(str(workdir), tag), *extra])
        exp = os.path.join(str(workdir), tag, "test_video", "DEBUG",
                           "experiment_0")
        if dist.get_rank() == 0:
            out[tag] = torch.load(os.path.join(exp, "netG"),
                                  map_location="cpu",
                                  weights_only=True)["gvars"]
        dist.barrier()
    if dist.get_rank() != 0:   # every rank checks rank 0's files
        out = {tag: torch.load(os.path.join(
            str(workdir), tag, "test_video", "DEBUG", "experiment_0",
            "netG"), map_location="cpu", weights_only=True)["gvars"]
            for tag in ("plain", "ahead")}
    return {"threads": sorted(threads), "collectives": calls[0], **out}


PROGRAMS = {"k4": program_k4, "halo": program_halo, "k4gp": program_k4gp,
            "steps": program_steps,
            "ladder_both": program_ladder_both,
            "ladder_one": program_ladder_one, "models": program_models,
            "sampling": program_sampling, "ahead_mesh": program_ahead_mesh}


def serve_rank(argv) -> None:
    """``serve <rank> <world> <port> <timeout_s> <serve args...>``: one
    rank of ``cli.serve`` over a group whose collectives time out after
    ``timeout_s``."""
    rank, world, port, timeout_s, *args = argv
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from hpvaegan_tpu_torch.cli import serve
    from hpvaegan_tpu_torch.parallel import maybe_initialize
    maybe_initialize(True, coordinator_address=f"127.0.0.1:{port}",
                     num_processes=int(world), process_id=int(rank),
                     timeout_s=float(timeout_s))
    serve.main(args)


def main(argv) -> None:
    if argv[0] == "serve":
        return serve_rank(argv[1:])
    program, rank, world, port, workdir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from hpvaegan_tpu_torch.parallel import maybe_initialize
    maybe_initialize(True, coordinator_address=f"127.0.0.1:{port}",
                     num_processes=world, process_id=rank, timeout_s=120)
    out = {}
    for name in program.split(","):
        out.update(PROGRAMS[name](MESHES[world], workdir))
    torch.save(out, os.path.join(workdir, f"{program}_{world}_{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
