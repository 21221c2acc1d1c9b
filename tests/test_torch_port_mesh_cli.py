"""The sampling entry points over a mesh on gloo CPU ranks, on the port's
tiny 3D run (tests/torch_port_runs.py):

* ``python -m hpvaegan_tpu_torch.cli.generate --mesh-shape 1x2
  --no-cuda``, once starting its two ranks itself and once as two ranks
  named by the launcher's environment: only rank 0 writes files (rank 1
  is given another ``--output-dir``, which must stay absent) and logs the
  metrics, and the files equal the one-process run's;
* ``cli.serve`` over two ranks (``tests/torch_port_ranks.py serve``, a
  group whose collectives time out after ``GROUP_TIMEOUT_S``): seeded,
  coalesced and rec requests over stdio answer what a one-process server
  answers to the same requests, with idle spells longer than the group's
  timeout between them; at EOF both ranks exit 0; a killed follower fails
  the server (a non-zero exit) within the timeout.

The files are AVIs of 8-bit frames: a sample within the f32 bar of the
one-process sample can still round to the next level where it lies on a
half step, so frames may differ by one level, and most are equal."""
import io
import json
import os
import select
import subprocess
import sys
import time

import numpy as np
import pytest

from hpvaegan_tpu_torch.cli import generate, serve
from hpvaegan_tpu_torch.parallel.distributed import LAUNCHER_VARS
from hpvaegan_tpu_torch.parallel.launch import free_port
from hpvaegan_tpu_torch.utils.logger import kept_logging
from hpvaegan_tpu_torch.utils.video_io import read_avi
from torch_port_ranks import REPO
from torch_port_runs import make_clip, one_torch_thread, port_run

GROUP_TIMEOUT_S = 4.0
RANKS = os.path.join(REPO, "tests", "torch_port_ranks.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def netG(tmp_path_factory):
    clip = make_clip(tmp_path_factory.mktemp("clip"))
    return os.path.join(port_run(clip, tmp_path_factory.mktemp("run")),
                        "netG")


def _main(cli, argv):
    with kept_logging():
        return cli.main(argv)


def _frames(directory, n, prefix="sample"):
    return [read_avi(os.path.join(str(directory), f"{prefix}_{i}.avi"))[0]
            for i in range(n)]


def _assert_same_files(got_dir, want_dir, n, prefix="sample"):
    names = sorted(os.listdir(str(want_dir)))
    assert sorted(os.listdir(str(got_dir))) == names
    for got, want in zip(_frames(got_dir, n, prefix),
                         _frames(want_dir, n, prefix)):
        assert got.shape == want.shape
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


@pytest.mark.parametrize("mode", [["--mode", "rand", "--num-samples", "3"],
                                  ["--inject-scale", "2"]])
def test_generate_starts_its_ranks(netG, tmp_path, mode):
    argv = ["--netG", netG, "--no-cuda", *mode]
    one = _main(generate, [*argv, "--output-dir", str(tmp_path / "one")])
    out = _main(generate, [*argv, "--output-dir", str(tmp_path / "two"),
                           "--mesh-shape", "1x2"])
    assert out == {"output_dir": str(tmp_path / "two"), "ranks": 2}
    _assert_same_files(tmp_path / "two", tmp_path / "one",
                       len(one["paths"]),
                       "inject" if "--inject-scale" in mode else "sample")


def _launch(args, world, port, rank_args=None, **popen):
    """``world`` processes of ``args`` named by the launcher's
    environment; ``rank_args(rank)`` adds a rank's own arguments."""
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **dict(zip(
            LAUNCHER_VARS, (f"127.0.0.1:{port}", str(world), str(rank)))))
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        extra = rank_args(rank) if rank_args else []
        procs.append(subprocess.Popen([*args, *extra], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      **popen))
    return procs


def test_generate_ranks_from_the_launcher_environment(netG, tmp_path):
    argv = ["--netG", netG, "--no-cuda", "--mode", "rec", "--metrics"]
    _main(generate, [*argv, "--output-dir", str(tmp_path / "one")])
    procs = _launch([sys.executable, "-m", "hpvaegan_tpu_torch.cli.generate",
                     *argv, "--mesh-shape", "1x2"], 2, free_port(),
                    lambda rank: ["--output-dir",
                                  str(tmp_path / f"rank{rank}")])
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert not (tmp_path / "rank1").exists()
    _assert_same_files(tmp_path / "rank0", tmp_path / "one", 4)
    assert "reconstruction PSNR" in logs[0]
    assert "reconstruction PSNR" not in logs[1]


# ---- the sharded server ----

SERVE_ARGS = ["--no-cuda", "--coalesce-ms", "30", "--warm", "rand,rec"]
REQUESTS = [{"num_samples": 2, "seed": 4, "prefix": "seeded"},
            {"num_samples": 1, "prefix": "c1"},
            {"num_samples": 1, "prefix": "c2"},
            {"num_samples": 1, "prefix": "c3"},
            {"mode": "rec", "prefix": "rec"}]


def _serve_ranks(netG, out_dir, world=2):
    port = free_port()
    args = ["--netG", netG, "--output-dir", str(out_dir), "--mesh-shape",
            f"1x{world}", *SERVE_ARGS]
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, RANKS, "serve", str(rank), str(world),
             str(port), str(GROUP_TIMEOUT_S), *args],
            env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdin=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            stdout=subprocess.PIPE,
            stderr=None if rank == 0 else subprocess.STDOUT, text=True))
    return procs


def _read_line(proc, timeout=120.0) -> dict:
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, "no response in time"
    line = proc.stdout.readline()
    assert line, f"rank 0 exited with {proc.wait()}"
    return json.loads(line)


def _one_process_responses(netG, out_dir):
    server, _ = serve.make_server(["--netG", netG, "--output-dir",
                                   str(out_dir), *SERVE_ARGS])
    try:
        out = io.StringIO()
        serve.serve_stdio(server, io.StringIO(
            "".join(json.dumps(r) + "\n" for r in REQUESTS)), out)
    finally:
        server.close()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_sharded_server_answers_as_one_process_and_survives_idle(netG,
                                                                 tmp_path):
    procs = _serve_ranks(netG, tmp_path / "two")
    try:
        assert _read_line(procs[0])["event"] == "ready"
        responses = []
        for i, req in enumerate(REQUESTS):
            if i in (1, 4):   # idle spells past the group's timeout
                time.sleep(2.5 * GROUP_TIMEOUT_S)
            procs[0].stdin.write(json.dumps(req) + "\n")
            procs[0].stdin.flush()
            responses.append(_read_line(procs[0]))
        procs[0].stdin.close()   # EOF: every rank stops
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0], procs[1].stdout.read()
    want = _one_process_responses(netG, tmp_path / "one")[1:]
    assert len(responses) == len(want) == len(REQUESTS)
    for got, ref in zip(responses, want):
        assert got["ok"] and ref["ok"], (got, ref)
        assert len(got["paths"]) == len(ref["paths"]) == got["num_samples"]
        assert got["device_ms"] > 0 and got["latency_ms"] >= got["device_ms"]
    for req, got in zip(REQUESTS, responses):
        _assert_same_files(tmp_path / "two", tmp_path / "one",
                           got["num_samples"], req["prefix"])


def test_a_killed_follower_fails_the_server(netG, tmp_path):
    procs = _serve_ranks(netG, tmp_path)
    try:
        assert _read_line(procs[0])["event"] == "ready"
        procs[1].kill()
        procs[1].wait()
        t0 = time.monotonic()
        code = procs[0].wait(timeout=3 * GROUP_TIMEOUT_S + 30)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert code == 1
    assert waited <= GROUP_TIMEOUT_S + 5, waited
