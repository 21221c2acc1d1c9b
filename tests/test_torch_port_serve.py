"""The port's ``python -m hpvaegan_tpu_torch.cli.serve`` on the port's
tiny 3D run (``--no-cuda``): one test for each of tests/test_serve.py's
(stdio JSON lines, ``write: false``, bad and non-object requests, a
server fault, an unknown warmup mode, seed determinism, rec, prefix
validation, the five coalescing cases, HTTP), plus the parser, the
``info()`` keys and the response keys equal to the JAX server's."""
import io
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from hpvaegan_tpu.cli import serve as jserve
from hpvaegan_tpu_torch.cli import serve
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.serving import SamplerSession, apply_snapshot
from hpvaegan_tpu_torch.utils.video_io import read_avi
from torch_port_runs import make_clip, one_torch_thread, port_run

TOP = (13, 12, 16, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def netg(tmp_path_factory):
    clip = make_clip(tmp_path_factory.mktemp("clip"))
    return os.path.join(port_run(clip, tmp_path_factory.mktemp("srun")),
                        "netG")


@pytest.fixture(scope="module")
def server(netg, tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_out")
    cfg = Config(netG=netg)
    applied = apply_snapshot(cfg, netg, set(), user_chose_source=False)
    assert "video_path" in applied  # the snapshot alone configures it
    cfg.adjust_scales()
    sess = SamplerSession(cfg, batch_size=2, manual_seed=0, device="cpu")
    srv = serve.Server(sess, str(out), default_num=2, seed0=0)
    yield srv
    srv.close()
    assert not srv.device.worker.is_alive()


def _roundtrip(server, lines):
    out_stream = io.StringIO()
    serve.serve_stdio(server, io.StringIO(lines), out_stream)
    return [json.loads(x) for x in out_stream.getvalue().splitlines()]


def _clip(path):
    frames, _ = read_avi(path)
    return frames.astype(np.int32)


def test_stdio_roundtrip(server):
    ready, resp, bye = _roundtrip(
        server, '{"id": "a", "num_samples": 3, "seed": 5}\n'
                '{"shutdown": true}\n')
    assert ready["event"] == "ready" and ready["ndim"] == 3
    assert bye == {"ok": True, "event": "shutdown"}
    assert resp["ok"] and resp["id"] == "a" and len(resp["paths"]) == 3
    assert resp["latency_ms"] > 0
    for path in resp["paths"]:
        assert os.path.basename(path).startswith("a_")
        assert _clip(path).shape == TOP


def test_write_false_skips_files(server):
    ready, resp, bye = _roundtrip(
        server, '{"id": "w0", "num_samples": 2, "seed": 5, "write": false}\n'
                '{"shutdown": true}\n')
    assert resp["ok"] and resp["paths"] == []
    assert resp["sample_shape"] == list(TOP)
    assert resp["device_ms"] > 0
    assert resp["latency_ms"] >= resp["device_ms"]
    assert not any(f.startswith("w0_") for f in os.listdir(server.out_dir))


def test_stdio_bad_requests_keep_serving(server):
    ready, bad_json, bad_mode, good = _roundtrip(
        server, 'not json\n{"mode": "nope"}\n{"num_samples": 1}\n')
    assert not bad_json["ok"] and "bad json" in bad_json["error"]
    assert not bad_mode["ok"] and "nope" in bad_mode["error"]
    assert bad_mode["client_error"] is True
    assert good["ok"] and len(good["paths"]) == 1  # server survived


def test_stdio_non_object_json_survives(server):
    ready, a, b, good = _roundtrip(server, 'null\n[1]\n{"num_samples": 1}\n')
    assert not a["ok"] and a["client_error"]
    assert not b["ok"] and b["client_error"]
    assert good["ok"]


def test_server_fault_not_client_error(server):
    orig = server.sess.sample_batch

    def boom(generator=None):
        raise OSError("disk full")

    server.sess.sample_batch = boom
    try:
        resp = server.handle({"num_samples": 1, "prefix": "fault"})
    finally:
        server.sess.sample_batch = orig
    assert not resp["ok"] and resp["client_error"] is False
    assert "disk full" in resp["error"]


def test_warmup_unknown_mode_raises(server):
    with pytest.raises(ValueError, match="unknown warmup mode"):
        server.sess.warmup(("rnad",))


def test_seed_determinism(server):
    a = server.handle({"num_samples": 2, "seed": 11, "prefix": "da"})
    b = server.handle({"num_samples": 2, "seed": 11, "prefix": "db"})
    c = server.handle({"num_samples": 2, "seed": 12, "prefix": "dc"})
    assert a["ok"] and b["ok"] and c["ok"]
    with open(a["paths"][0], "rb") as fa, open(b["paths"][0], "rb") as fb:
        assert fa.read() == fb.read()      # same seed == same file
    assert np.abs(_clip(a["paths"][0]) - _clip(c["paths"][0])).mean() > 0
    assert np.abs(_clip(a["paths"][0]) - _clip(a["paths"][1])).mean() > 0


def test_rec_mode(server):
    resp = server.handle({"mode": "rec", "num_samples": 1, "prefix": "rec"})
    assert resp["ok"] and resp["mode"] == "rec"
    assert _clip(resp["paths"][0]).shape == TOP


def test_prefix_validation(server):
    resp = server.handle({"num_samples": 1, "prefix": "../escape"})
    assert not resp["ok"] and "prefix" in resp["error"]
    assert resp["client_error"] is True


@pytest.fixture(scope="module")
def cserver(server, tmp_path_factory):
    """The coalescing variant sharing the module's session (capacity =
    batch_size = 2); a generous window so concurrently submitted requests
    share a dispatch on a loaded host."""
    out = tmp_path_factory.mktemp("serve_out_coalesce")
    srv = serve.Server(server.sess, str(out), default_num=2, seed0=0,
                       coalesce_ms=500.0)
    yield srv
    srv.close()
    assert not srv.coalescer.worker.is_alive()


def _concurrent(srv, reqs):
    resps = [None] * len(reqs)

    def go(i):
        resps[i] = srv.handle(reqs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return resps


def test_coalesce_concurrent_singles_share_a_dispatch(cserver):
    before = cserver.coalescer.dispatches
    resps = _concurrent(cserver, [{"num_samples": 1, "prefix": f"co{i}"}
                                  for i in range(2)])
    assert all(r is not None and r["ok"] for r in resps), resps
    assert all(len(r["paths"]) == 1 for r in resps)
    assert cserver.coalescer.dispatches == before + 1
    clips = [_clip(r["paths"][0]) for r in resps]
    assert np.abs(clips[0] - clips[1]).mean() > 0  # distinct slots


def test_coalesce_large_request_spans_dispatches(cserver):
    before = cserver.coalescer.dispatches
    resp = cserver.handle({"num_samples": 5, "prefix": "big"})
    assert resp["ok"] and len(resp["paths"]) == 5
    assert cserver.coalescer.dispatches == before + 3  # ceil(5/2)


def test_coalesce_exact_multiple_bypasses_queue(cserver):
    before = cserver.coalescer.dispatches
    resp = cserver.handle({"num_samples": 4, "prefix": "full"})
    assert resp["ok"] and len(resp["paths"]) == 4
    assert cserver.coalescer.dispatches == before  # queue untouched


def test_coalesce_seeded_request_bypasses_queue(cserver, server):
    before = cserver.coalescer.dispatches
    a = cserver.handle({"num_samples": 1, "seed": 11, "prefix": "cs"})
    b = server.handle({"num_samples": 1, "seed": 11, "prefix": "ns"})
    assert a["ok"] and b["ok"]
    assert cserver.coalescer.dispatches == before  # queue untouched
    np.testing.assert_array_equal(_clip(a["paths"][0]), _clip(b["paths"][0]))


def test_coalesce_fault_fails_request_not_worker(cserver):
    orig = cserver.sess.sample_batch

    def boom(generator=None):
        raise OSError("device gone")

    cserver.sess.sample_batch = boom
    try:
        resp = cserver.handle({"num_samples": 1, "prefix": "cf"})
    finally:
        cserver.sess.sample_batch = orig
    assert not resp["ok"] and resp["client_error"] is False
    assert "device gone" in resp["error"]
    again = cserver.handle({"num_samples": 1, "prefix": "cf2"})
    assert again["ok"] and len(again["paths"]) == 1


def test_http_roundtrip(server):
    box = {}
    started = threading.Event()

    def ready_cb(httpd):
        box["httpd"] = httpd
        started.set()

    t = threading.Thread(target=serve.serve_http,
                         args=(server, "127.0.0.1", 0, ready_cb),
                         daemon=True)
    t.start()
    assert started.wait(30)
    port = box["httpd"].server_address[1]
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == server.info()

        body = json.dumps({"id": "h1", "num_samples": 2,
                           "seed": 3}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            resp = json.loads(r.read())
        assert resp["ok"] and len(resp["paths"]) == 2
        assert all(_clip(p).shape == TOP for p in resp["paths"])

        # bad request -> 400 + error payload, server stays up
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=b'{"mode": "x"}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400
    finally:
        box["httpd"].shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, a.required, a.const, type(a).__name__)
            for a in parser._actions}


def test_parser_equals_the_jax_parser():
    assert _actions(serve.build_parser()) == _actions(jserve.build_parser())


class _StubSession:
    """What the two servers read of a session, for the JAX server's
    answers without a JAX model."""
    ndim, scale, batch_size, device = 3, 4, 2, "cpu"
    cfg = types.SimpleNamespace(generator="GeneratorHPVAEGAN")

    def sample_batch(self, *args, **kw):
        return np.zeros((2, *TOP), np.float32)

    def write_sample(self, frame, path_base):
        return path_base + ".avi"


def test_info_and_response_keys_equal_the_jax_servers(tmp_path):
    servers = [mod.Server(_StubSession(), str(tmp_path / mod.__name__),
                          default_num=2, seed0=0) for mod in (jserve, serve)]
    jax_info, port_info = (s.info() for s in servers)
    assert set(port_info) == set(jax_info)
    reqs = [{"id": "a", "num_samples": 3}, {"num_samples": 1,
                                            "write": False},
            {"mode": "nope"}, None]
    for req in reqs:
        jax_resp, port_resp = (s.handle(req) for s in servers)
        assert set(port_resp) == set(jax_resp), req
        assert port_resp["ok"] == jax_resp["ok"]
        assert port_resp.get("client_error") == jax_resp.get("client_error")
    servers[1].close()


class _ThreadRecordingSession(_StubSession):
    """A stub session that records the thread of each device call."""

    def __init__(self):
        self.threads = []

    def warmup(self, modes):
        self.threads.append(threading.get_ident())

    def sample_batch(self, *args, **kw):
        self.threads.append(threading.get_ident())
        return super().sample_batch()


def test_all_device_work_runs_on_one_persistent_thread(tmp_path):
    """Warmup, stdio, coalesced and HTTP requests (each HTTP connection in
    a handler thread of its own) all reach the session from the server's
    one device thread, so no request pays a new thread's first calls."""
    sess = _ThreadRecordingSession()
    srv = serve.Server(sess, str(tmp_path), default_num=1, seed0=0,
                       coalesce_ms=50.0)
    try:
        srv.device.run(sess.warmup, ("rand",))
        _roundtrip(srv, '{"num_samples": 2, "seed": 1, "write": false}\n')
        _concurrent(srv, [{"num_samples": 1, "write": False}] * 2)
        box, started = {}, threading.Event()

        def ready_cb(httpd):
            box["httpd"] = httpd
            started.set()

        t = threading.Thread(target=serve.serve_http,
                             args=(srv, "127.0.0.1", 0, ready_cb),
                             daemon=True)
        t.start()
        assert started.wait(30)
        try:
            for seed in (2, 3):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{box['httpd'].server_address[1]}"
                    "/generate", headers={"Content-Type":
                                          "application/json"},
                    data=json.dumps({"num_samples": 2, "seed": seed,
                                     "write": False}).encode())
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert json.loads(r.read())["ok"]
        finally:
            box["httpd"].shutdown()
            t.join(timeout=30)
    finally:
        srv.close()
    assert len(sess.threads) >= 5
    assert set(sess.threads) == {srv.device.worker.ident}
    assert srv.device.worker.ident != threading.get_ident()
    assert not srv.device.worker.is_alive()
    with pytest.raises(RuntimeError, match="device thread closed"):
        srv.device.run(sess.warmup, ("rand",))


def test_device_thread_raises_the_jobs_exception_in_the_caller():
    device = serve.DeviceThread()
    try:
        assert device.run(lambda a, b: a + b, 2, 3) == 5
        with pytest.raises(OSError, match="device gone"):
            device.run(lambda: (_ for _ in ()).throw(OSError("device gone")))
        assert device.run(lambda: 7) == 7   # the thread survives
    finally:
        device.close()
    assert not device.worker.is_alive()


def test_make_server_builds_what_the_command_line_says(netg, tmp_path):
    server, args = serve.make_server(
        ["--netG", netg, "--no-cuda", "--coalesce-ms", "20", "--warm",
         "rand,rec", "--output-dir", str(tmp_path / "out"), "--batch-size",
         "3"])
    try:
        assert args.coalesce_ms == 20.0 and server.coalescer is not None
        assert server.sess.batch_size == server.coalescer.capacity == 3
        assert server.info()["output_dir"] == str(tmp_path / "out")
        ready, resp = _roundtrip(server, '{"num_samples": 1}\n')
        assert resp["ok"] and len(resp["paths"]) == 1
    finally:
        server.close()
    with pytest.raises(ValueError, match="unknown warmup mode"):
        serve.make_server(["--netG", netg, "--no-cuda", "--warm", "nope",
                           "--output-dir", str(tmp_path / "o2")])
