"""Persistent sampling server (port of ``hpvaegan_tpu/cli/serve.py``).

    python -m hpvaegan_tpu_torch.cli.serve --netG <run>/netG          # stdio
    python -m hpvaegan_tpu_torch.cli.serve --netG <run>/netG --port 8000

loads the checkpoint once (``SamplerSession``, on the card unless
``--no-cuda``), warms the samplers up (``--warm``), then answers sampling
requests.  Two transports share one request handler:

* **stdio** (default): one JSON object per stdin line, one JSON response
  per stdout line; ``{"shutdown": true}`` or EOF stops it;
* **HTTP** (``--port N``): ``POST /generate`` with the same JSON body,
  ``GET /healthz`` for liveness (stdlib ``ThreadingHTTPServer``).

Request fields (all optional): ``mode`` ("rand"|"rec", default rand),
``num_samples`` (default ``--num-samples``), ``seed`` (int; default a
per-request counter mixed into ``--manualSeed``), ``prefix`` (the output
file name prefix, default the request id), ``write`` (false skips the
sample files; the response then carries shapes and timings only).  A
response carries ``id``, ``ok``, ``mode``, ``num_samples``, ``paths``,
``sample_shape`` (without files), ``device_ms`` (from the hand-over to
the device thread until the batches are back on the host) and
``latency_ms`` (with the file writes, which run outside the device
thread, so concurrent clients overlap them with the next batch), or ``client_error`` and ``error``; HTTP maps a client error to
400 and a server fault to 500.

All device work (warmup, solo and coalesced dispatches) runs on one
persistent thread (``DeviceThread``): the transport threads hand it
their batches and wait.  PyTorch sets up per-thread state on a thread's
first CUDA calls, so a call in a fresh thread is slower; HTTP serves
each connection in a new thread and would pay that on every request.
Batch ``i`` of a seeded request draws from ``seeded_generator(seed,
1000 + i)``, of an unseeded one from ``seeded_generator(manualSeed, seq,
1000 + i)`` with ``seq`` the request's number, each made on the
session's device in the device thread.

``--coalesce-ms W`` packs unseeded rand requests into shared dispatches
of the fixed batch (``CoalescingDispatcher``): a worker fills up to
``--batch-size`` slots, waiting at most W ms for co-travellers, and hands
each request its rows; its n-th dispatch draws from
``seeded_generator(manualSeed, 0x7fffffff, n)``.  Seeded requests, rec
requests and requests of an exact multiple of the batch keep their solo
dispatch.  A fault in a dispatch fails only the requests packed into it.

``--mesh-shape DxS`` serves over a mesh of ranks (JAX
``cli/serve.py:411-415``; the launch as ``cli.generate``'s).  Rank 0
owns the transport, the ``Server``, the dispatcher and the one
``DeviceThread``; every other rank runs a ``Follower``.  On the device
thread rank 0 announces each session call before it makes it: a
fixed-size int64 descriptor ``(op, mode, seed)`` broadcast over the
group, ``seed`` the 64-bit value of the call's generator
(``utils.tools.seed_value``), so that every rank makes the same call on
the same draws.  While the device thread is idle it announces a
keep-alive every quarter of the group's timeout, so the followers, which
wait in that broadcast, outlive any idle spell; a keep-alive that fails
(a rank died) ends the server with exit code 1.  ``Server.close()``
(EOF on stdin, ``{"shutdown": true}``, the end of HTTP serving)
announces the stop, and the followers return.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from ..parallel import distributed as _dist
from ..parallel import multihost
from ..serving import SamplerSession
from ..utils.tools import seed_value
from .generate import build_parser as gen_parser
from .generate import launch_ranks, open_session

__all__ = ["build_parser", "DeviceThread", "CoalescingDispatcher", "Server",
           "Follower", "serve_stdio", "serve_http", "make_server", "main"]

_COALESCE_STREAM = 0x7fffffff
# a sharded server's descriptor: (op, mode, seed)
_STOP, _RUN, _ALIVE = 0, 1, 2
_MODES = ("rand", "rec", "warm_rand", "warm_rec")


def session_call(sess: SamplerSession, mode: str, seed: int):
    """The session call of a dispatch: a rand or rec batch drawn from a
    generator seeded with ``seed``, or a warmup (``warm_<mode>``, which
    returns None)."""
    if mode.startswith("warm_"):
        return sess.warmup([mode[len("warm_"):]])
    g = torch.Generator(device=sess.device).manual_seed(seed)
    if mode == "rec":
        return sess.reconstruct_batch(None, g)
    return sess.sample_batch(g)


def _announce(op: int, mode: str = "rand", seed: int = 0) -> None:
    """Rank 0's descriptor of the next session call, to every rank."""
    signed = seed - (1 << 64) if seed >= 1 << 63 else seed
    _dist.broadcast_(torch.tensor([op, _MODES.index(mode), signed],
                                  dtype=torch.int64))


def _receive():
    """``(op, mode, seed)`` as rank 0 announced them."""
    t = _dist.broadcast_(torch.zeros(3, dtype=torch.int64))
    op, mode, seed = (int(v) for v in t)
    return op, _MODES[mode], seed & ((1 << 64) - 1)


def build_parser() -> argparse.ArgumentParser:
    # the model/pyramid/override surface of generate (the snapshot
    # restores training flags; explicit flags win), plus the server knobs
    p = gen_parser()
    p.description = "persistent sampling server (stdio JSON-lines or HTTP)"
    p.add_argument("--port", type=int, default=0,
                   help="serve HTTP on this port (default: stdio JSON lines)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--warm", type=str, default="rand",
                   help="comma-separated modes to run once at startup "
                        "(rand,rec); empty to skip warmup")
    p.add_argument("--coalesce-ms", type=float, default=0.0,
                   help="batched request scheduler: pack unseeded rand "
                        "requests into shared device dispatches, waiting "
                        "up to this many ms to fill a batch (0 = off; "
                        "seeded/rec requests always dispatch solo)")
    return p


class DeviceThread:
    """The one thread that runs the session's device work, in the order
    it is handed over: ``run(fn, *args)`` blocks until ``fn(*args)`` has
    run there, and returns its result or raises its exception.
    ``idle``: ``(seconds, fn)``, ``fn()`` runs there after each idle spell
    of that many seconds."""

    def __init__(self, idle: Optional[tuple] = None):
        self.idle = idle
        self.jobs: queue.Queue = queue.Queue()
        self.lock = threading.Lock()   # no job is queued after the stop
        self.running = True
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def run(self, fn: Callable, *args):
        job = {"call": (fn, args), "done": threading.Event()}
        with self.lock:
            if not self.running:
                raise RuntimeError("device thread closed")
            self.jobs.put(job)
        job["done"].wait()
        if "error" in job:
            raise job["error"]
        return job["out"]

    def close(self) -> None:
        with self.lock:
            if self.running:
                self.running = False
                self.jobs.put(None)
        self.worker.join(timeout=10)

    def _run(self) -> None:
        while True:
            try:
                job = self.jobs.get(timeout=self.idle and self.idle[0])
            except queue.Empty:
                self.idle[1]()
                continue
            if job is None:
                return
            fn, args = job["call"]
            try:
                job["out"] = fn(*args)
            except BaseException as e:  # raised in the caller's thread
                job["error"] = e
            job["done"].set()


class CoalescingDispatcher:
    """Cross-request micro-batching onto the fixed-batch sampler.

    One daemon worker owns the coalesced dispatches: transport threads
    ``submit()`` an entry (``num`` samples wanted) and block; the worker
    drains the queue in arrival order, packs up to ``capacity`` sample
    slots per dispatch — waiting at most ``window_s`` for co-travellers
    when a batch isn't full — runs ONE ``sample_batch`` on the server's
    device thread, and distributes row slices back.  A request
    larger than the capacity spans several dispatches.  Faults in a
    dispatch fail only the requests packed into it; the worker survives.
    """

    def __init__(self, sess: SamplerSession, device: DeviceThread,
                 window_s: float, seed0: int, batch: Callable):
        self.sess = sess
        self.device = device
        self.batch = batch   # the device thread's (mode, seed) -> batch
        self.window_s = window_s
        self.capacity = sess.batch_size
        self.seed0 = seed0
        self.cond = threading.Condition()
        self.queue: list = []          # entries in arrival order
        self.running = True
        self.dispatches = 0            # observability + tests
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def submit(self, num: int) -> list:
        """Block until ``num`` sample rows are produced; returns a list of
        row arrays (chunks).  Raises the dispatch's exception on fault."""
        entry = {"remaining": num, "chunks": [], "done": threading.Event(),
                 "error": None}
        with self.cond:
            if not self.running:
                raise RuntimeError("dispatcher closed")
            self.queue.append(entry)
            self.cond.notify_all()
        entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["chunks"]

    def close(self) -> None:
        with self.cond:
            self.running = False
            self.cond.notify_all()
        self.worker.join(timeout=10)

    def _pack(self) -> list:
        """Under self.cond: take (entry, take) pairs filling <= capacity
        slots from the queue front."""
        plan, fill = [], 0
        for entry in self.queue:
            take = min(entry["remaining"], self.capacity - fill)
            if take > 0:
                plan.append((entry, take))
                fill += take
            if fill == self.capacity:
                break
        return plan

    def _run(self) -> None:
        n = 0
        while True:
            with self.cond:
                while self.running and not self.queue:
                    self.cond.wait()
                if not self.running:
                    for entry in self.queue:
                        entry["error"] = RuntimeError("dispatcher closed")
                        entry["done"].set()
                    self.queue.clear()
                    return
                # under-full batch: linger up to the window for
                # co-travellers (new arrivals notify the condition)
                deadline = time.monotonic() + self.window_s
                while (self.running
                       and sum(e["remaining"] for e in self.queue)
                       < self.capacity):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self.cond.wait(timeout=left)
                plan = self._pack()
                n += 1
            try:
                out = self.device.run(self._dispatch, n)
            except Exception as e:  # fail only this dispatch's requests
                with self.cond:
                    self.dispatches += 1
                    for entry, _ in plan:
                        if entry in self.queue:
                            self.queue.remove(entry)
                        entry["error"] = e
                        entry["done"].set()
                continue
            with self.cond:
                self.dispatches += 1
                offset = 0
                for entry, take in plan:
                    entry["chunks"].append(out[offset:offset + take])
                    offset += take
                    entry["remaining"] -= take
                    if entry["remaining"] == 0:
                        self.queue.remove(entry)
                        entry["done"].set()

    def _dispatch(self, n: int):
        """The device thread's part of the n-th dispatch."""
        return self.batch("rand", seed_value(self.seed0, _COALESCE_STREAM,
                                             n))


class Server:
    """Transport-agnostic request handler around a SamplerSession."""

    def __init__(self, sess: SamplerSession, out_dir: str,
                 default_num: int, seed0: int, coalesce_ms: float = 0.0):
        self.sess = sess
        self.out_dir = out_dir
        self.default_num = default_num
        self.seed0 = seed0
        self.counter = 0
        self.lock = threading.Lock()  # the request counter
        self.mesh = getattr(sess, "mesh", None)
        # serialises all device work; under a mesh it keeps the followers
        # of an idle server alive
        self.device = DeviceThread(
            None if self.mesh is None
            else (_dist.group_timeout_s() / 4, self._keep_alive))
        self.coalescer = (CoalescingDispatcher(sess, self.device,
                                               coalesce_ms / 1e3, seed0,
                                               self.batch)
                          if coalesce_ms > 0 else None)
        os.makedirs(out_dir, exist_ok=True)

    def batch(self, mode: str, seed: int):
        """On the device thread: one session call (``session_call``),
        announced to the followers first under a mesh."""
        if self.mesh is not None:
            _announce(_RUN, mode, seed)
        return session_call(self.sess, mode, seed)

    def warmup(self, modes) -> None:
        """On the device thread: one warmup batch a mode."""
        for mode in modes:
            if mode not in ("rand", "rec"):
                raise ValueError(f"unknown warmup mode {mode!r} (rand|rec)")
            self.batch(f"warm_{mode}", 0)

    def _keep_alive(self) -> None:
        """The idle device thread's keep-alive; a group that fails it has
        lost a rank, and the server ends."""
        try:
            _announce(_ALIVE)
        except Exception:
            logging.exception("a rank of the sharded server is gone")
            logging.shutdown()
            os._exit(1)

    def info(self) -> dict:
        return {"ok": True, "event": "ready", "ndim": self.sess.ndim,
                "scale": self.sess.scale,
                "batch_size": self.sess.batch_size,
                "generator": self.sess.cfg.generator,
                "coalesce": self.coalescer is not None,
                "output_dir": self.out_dir}

    def handle(self, req) -> dict:
        """Serve one request dict.  Never raises: bad requests come back
        ``{"ok": False, "client_error": True}``, server-side faults (disk,
        device) ``{"ok": False, "client_error": False}``."""
        rid = req.get("id", None) if isinstance(req, dict) else None
        try:
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, "
                                 f"got {type(req).__name__}")
            plan = self._parse(req, rid)
            t0 = time.perf_counter()
            if self.coalescer is not None and plan["coalesce"]:
                # a coalesced request's device_ms spans its queue wait and
                # its shared dispatches
                outs = self.coalescer.submit(plan["num"])
            else:
                outs = self.device.run(self._device_batches, plan)
            device_ms = (time.perf_counter() - t0) * 1e3
            resp = self._finish(plan, outs, rid)
            resp["device_ms"] = round(device_ms, 2)
            resp["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
            return resp
        except (ValueError, TypeError, KeyError) as e:
            return {"id": rid, "ok": False, "client_error": True,
                    "error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # server fault must not kill the server
            logging.exception("request failed server-side")
            return {"id": rid, "ok": False, "client_error": False,
                    "error": f"{type(e).__name__}: {e}"}

    def _parse(self, req: dict, rid) -> dict:
        mode = req.get("mode", "rand")
        if mode not in ("rand", "rec"):
            raise ValueError(f"unknown mode {mode!r} (rand|rec)")
        num = int(req.get("num_samples", self.default_num))
        if not 1 <= num <= 4096:
            raise ValueError(f"num_samples {num} out of range [1, 4096]")
        write = bool(req.get("write", True))
        with self.lock:
            self.counter += 1
            seq = self.counter
        seed = req.get("seed", None)
        stream = (int(seed),) if seed is not None else (self.seed0, seq)
        prefix = str(req.get("prefix", rid if rid is not None else
                             f"req{seq}"))
        if os.path.sep in prefix or prefix in ("", ".", ".."):
            raise ValueError(f"bad prefix {prefix!r}")
        # coalescible = the server was free to choose the draws anyway.
        # Exact-multiple-of-capacity requests bypass the queue: they have
        # no waste slots to reclaim, and FIFO slot-packing would split
        # them across dispatches whenever arrivals interleave.
        cap = self.coalescer.capacity if self.coalescer is not None else 0
        return {"mode": mode, "num": num, "write": write, "stream": stream,
                "prefix": prefix,
                "coalesce": (mode == "rand" and seed is None
                             and not (cap and num % cap == 0))}

    def _device_batches(self, plan: dict) -> list:
        """The device thread's part of a solo request: the batches,
        copied to the host; no disk IO."""
        outs = []
        produced = 0
        batch_idx = 0
        while produced < plan["num"]:
            out = self.batch(plan["mode"],
                             seed_value(*plan["stream"], 1000 + batch_idx))
            outs.append(out)
            produced += out.shape[0]
            batch_idx += 1
        return outs

    def _finish(self, plan: dict, outs: list, rid) -> dict:
        """In the caller's thread: write the sample files (skipped for ``"write":
        false`` requests)."""
        resp = {"id": rid, "ok": True, "mode": plan["mode"],
                "num_samples": plan["num"]}
        if not plan["write"]:
            resp["paths"] = []
            resp["sample_shape"] = list(outs[0].shape[1:])
            return resp
        paths = []
        produced = 0
        for out in outs:
            for b in range(out.shape[0]):
                if produced >= plan["num"]:
                    break
                paths.append(self.sess.write_sample(
                    out[b],
                    os.path.join(self.out_dir,
                                 f"{plan['prefix']}_{produced}")))
                produced += 1
        resp["paths"] = paths
        return resp

    def close(self) -> None:
        if self.coalescer is not None:
            self.coalescer.close()
        if self.mesh is not None:
            try:
                self.device.run(_announce, _STOP)
            except RuntimeError:   # closed already, or the group is gone
                logging.exception("could not stop the followers")
        self.device.close()


class Follower:
    """A rank other than 0 of a sharded server: it makes the session
    calls that rank 0 announces, in order, on this one thread, until the
    stop.  A call that fails here fails on rank 0 too (the same call on
    the same files and draws) and is logged; a failed announcement (rank
    0 is gone) raises."""

    def __init__(self, sess: SamplerSession):
        self.sess = sess

    def run(self) -> None:
        while True:
            op, mode, seed = _receive()
            if op == _STOP:
                return
            if op == _RUN:
                try:
                    session_call(self.sess, mode, seed)
                except Exception:
                    logging.exception(f"dispatch {mode} failed here")


def serve_stdio(server: Server, in_stream, out_stream) -> None:
    """One JSON request per line in, one JSON response per line out.
    A line ``{"shutdown": true}`` (or EOF) stops the server."""
    print(json.dumps(server.info()), file=out_stream, flush=True)
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                  file=out_stream, flush=True)
            continue
        if isinstance(req, dict) and req.get("shutdown"):
            print(json.dumps({"ok": True, "event": "shutdown"}),
                  file=out_stream, flush=True)
            return
        print(json.dumps(server.handle(req)), file=out_stream, flush=True)


def serve_http(server: Server, host: str, port: int,
               ready_cb=None) -> None:
    """Serve HTTP until ``shutdown()`` of the server object that
    ``ready_cb`` receives (or an interrupt)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, server.info())
            else:
                self._send(404, {"ok": False, "error": "GET /healthz only"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"ok": False,
                                 "error": "POST /generate only"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, OSError) as e:
                self._send(400, {"ok": False, "error": f"bad json: {e}"})
                return
            resp = server.handle(req)
            code = 200 if resp.get("ok") else (
                400 if resp.get("client_error") else 500)
            self._send(code, resp)

        def log_message(self, fmt, *args):
            logging.info("http: " + fmt % args)

    httpd = ThreadingHTTPServer((host, port), Handler)
    logging.info(f"serving on http://{host}:{httpd.server_address[1]} "
                 f"(POST /generate, GET /healthz)")
    if ready_cb is not None:
        ready_cb(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def make_server(argv: Optional[Sequence[str]] = None):
    """``(server, args)`` as the command line says: the session (on the
    card unless ``--no-cuda``), the server around it, warmed up.  Under
    ``--mesh-shape`` that is rank 0's; the other ranks get their
    ``Follower``."""
    args = build_parser().parse_args(argv)
    # the server scores nothing: --svfid/--sifid parse and are ignored
    # on either ndim, as in the JAX server
    sess = open_session(args, build_parser, argv, check_metrics=False)
    if sess.mesh is not None and not multihost.is_primary():
        return Follower(sess), args
    out_dir = args.output_dir or os.path.join(os.path.dirname(args.netG),
                                              "serve")
    server = Server(sess, out_dir, default_num=args.num_samples,
                    seed0=args.manualSeed, coalesce_ms=args.coalesce_ms)
    warm = [m.strip() for m in args.warm.split(",") if m.strip()]
    if warm:
        t0 = time.perf_counter()
        try:  # on the device thread, which then serves warm
            server.device.run(server.warmup, warm)
        except BaseException:
            server.close()
            raise
        logging.info(f"warmup({','.join(warm)}): "
                     f"{time.perf_counter() - t0:.1f}s")
    return server, args


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    if launch_ranks(build_parser().parse_args(argv), argv,
                    "hpvaegan_tpu_torch.cli.serve"):
        return
    server, args = make_server(argv)
    if isinstance(server, Follower):
        server.run()
        return
    try:
        if args.port:
            serve_http(server, args.host, args.port)
        else:
            serve_stdio(server, sys.stdin, sys.stdout)
    finally:
        server.close()


if __name__ == "__main__":
    main()
