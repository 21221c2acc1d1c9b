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

from ..serving import SamplerSession
from ..utils.tools import seeded_generator
from .generate import build_parser as gen_parser
from .generate import open_session

__all__ = ["build_parser", "DeviceThread", "CoalescingDispatcher", "Server",
           "serve_stdio", "serve_http", "make_server", "main"]

_COALESCE_STREAM = 0x7fffffff


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
    run there, and returns its result or raises its exception."""

    def __init__(self):
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
            job = self.jobs.get()
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
                 window_s: float, seed0: int):
        self.sess = sess
        self.device = device
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
        return self.sess.sample_batch(seeded_generator(
            self.seed0, _COALESCE_STREAM, n, device=self.sess.device))


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
        self.device = DeviceThread()  # serialises all device work
        self.coalescer = (CoalescingDispatcher(sess, self.device,
                                               coalesce_ms / 1e3, seed0)
                          if coalesce_ms > 0 else None)
        os.makedirs(out_dir, exist_ok=True)

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
            g = seeded_generator(*plan["stream"], 1000 + batch_idx,
                                 device=self.sess.device)
            if plan["mode"] == "rec":
                out = self.sess.reconstruct_batch(None, g)
            else:
                out = self.sess.sample_batch(g)
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
        self.device.close()


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
    card unless ``--no-cuda``), the server around it, warmed up."""
    args = build_parser().parse_args(argv)
    sess = open_session(args, build_parser, argv)
    out_dir = args.output_dir or os.path.join(os.path.dirname(args.netG),
                                              "serve")
    server = Server(sess, out_dir, default_num=args.num_samples,
                    seed0=args.manualSeed, coalesce_ms=args.coalesce_ms)
    warm = [m.strip() for m in args.warm.split(",") if m.strip()]
    if warm:
        t0 = time.perf_counter()
        try:  # on the device thread, which then serves warm
            server.device.run(sess.warmup, warm)
        except BaseException:
            server.close()
            raise
        logging.info(f"warmup({','.join(warm)}): "
                     f"{time.perf_counter() - t0:.1f}s")
    return server, args


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    server, args = make_server(argv)
    try:
        if args.port:
            serve_http(server, args.host, args.port)
        else:
            serve_stdio(server, sys.stdin, sys.stdout)
    finally:
        server.close()


if __name__ == "__main__":
    main()
