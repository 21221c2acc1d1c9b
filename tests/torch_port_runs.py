"""Shared by the tests of the port's sampling surface: the tiny 3D runs
they sample from, trained in-process by the JAX CLI and by the port's
CLI on a copy of tests/assets/test_video.avi (its frames file written by
``decode_frames``), with the tiny flags of
tests/test_torch_port_train_cli.py."""
import contextlib
import fcntl
import importlib
import os
import shutil
import sys

import torch

from hpvaegan_tpu_torch.utils.logger import kept_logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CLIP = os.path.join(REPO, "tests", "assets", "test_video.avi")
TINY = ["--img-size", "16", "--min-size", "8", "--max-size", "16",
        "--niter", "2", "--nfc", "8", "--num-layer", "2", "--batch-size", "2",
        "--manualSeed", "5", "--latent-dim", "8", "--enc-blocks", "1",
        "--vae-levels", "2", "--no-cuda"]


@contextlib.contextmanager
def one_torch_thread():
    """The models are tiny: one intra-op thread is faster, and it keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)




def make_clip(directory) -> str:
    """A copy of the test clip in ``directory``, decoded once."""
    from hpvaegan_tpu_torch.tools.decode_frames import decode_frames
    path = os.path.join(str(directory), "test_video.avi")
    shutil.copy(TEST_CLIP, path)
    decode_frames(path)
    return path


def experiment(run_dir, n: int = 0) -> str:
    return os.path.join(str(run_dir), "test_video", "DEBUG",
                        f"experiment_{n}")


def jax_run(clip: str, run_dir) -> str:
    """The JAX CLI's tiny run; returns its experiment directory."""
    mod = importlib.import_module("hpvaegan_tpu.cli.train_video")
    old = sys.argv
    sys.argv = (["train_video.py", "--video-path", clip, *TINY,
                 "--run-dir", str(run_dir)])
    try:
        with kept_logging():
            mod.main()
    finally:
        sys.argv = old
    return experiment(run_dir)


def port_run(clip: str, run_dir, *extra: str) -> str:
    """The port CLI's tiny run; returns its experiment directory."""
    from hpvaegan_tpu_torch.cli import train_video
    with kept_logging():
        train_video.main(["--video-path", clip, *TINY,
                          "--run-dir", str(run_dir), *extra])
    return experiment(run_dir)


def shared_jax_run(tmp_path_factory) -> str:
    """The JAX CLI's tiny run, trained once per test session: under
    pytest-xdist the workers share it through the session's common
    temporary directory, one training it under a file lock (the JAX run
    costs most of a minute of compiles)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "jax_tiny_run"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            exp = experiment(root / "run")
            if not os.path.exists(os.path.join(exp, "done")):
                shutil.rmtree(root / "run", ignore_errors=True)
                clip = make_clip(root)
                jax_run(clip, root / "run")
                open(os.path.join(exp, "done"), "w").close()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return exp
