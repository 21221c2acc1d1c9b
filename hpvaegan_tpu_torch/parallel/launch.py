"""The local launch: a CLI started as the ranks of a mesh on this host
(the port's counterpart of the JAX package's multi-host launchers, which
a TPU pod provides).

``spawn_ranks`` starts ``n`` fresh interpreters of a CLI module, each
given the launcher's environment (``distributed.LAUNCHER_VARS``): one
rank a card, or gloo CPU ranks under ``--no-cuda``.  The training CLIs
take ``--distributed`` to become a rank; the sampling CLIs (``generate``,
``serve``), whose parsers stay the JAX CLIs', become one when the
environment names them.  Rank 0 inherits stdin and stdout (a server's
transport); the other ranks read nothing and write their stdout to
stderr.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

import torch

from .. import resolve_device
from .distributed import LAUNCHER_VARS

__all__ = ["spawn_ranks", "free_port"]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: Sequence[str], n: int, no_cuda: bool,
                poll_s: float = 0.2,
                module: str = "hpvaegan_tpu_torch.cli.train_video",
                flags: Sequence[str] = ("--distributed",)) -> None:
    """Run the CLI ``module`` as ``n`` ranks on this host: fresh
    interpreters given ``argv`` plus ``flags`` and the launcher's
    environment, one a card (gloo CPU ranks under ``--no-cuda``, which
    share the host's cores unless ``OMP_NUM_THREADS`` says otherwise).
    Raises when the host has fewer cards than ranks.  Waits for all; when
    one fails the others are stopped and RuntimeError names it."""
    if not no_cuda:
        resolve_device("cuda")
        cards = torch.cuda.device_count()
        if cards < n:
            raise ValueError(
                f"the mesh has {n} positions and this host {cards} CUDA "
                f"card(s): the local launch starts one rank a card; start "
                f"the ranks yourself with the launcher's environment "
                f"(ranks may then share a card, over gloo)")
    root = str(Path(__file__).resolve().parents[2])
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, **dict(zip(
                LAUNCHER_VARS, (coordinator, str(n), str(rank)))))
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in [env.get("PYTHONPATH")] if p])
            if no_cuda:
                env.setdefault("OMP_NUM_THREADS",
                               str(max(1, (os.cpu_count() or 1) // n)))
            io = {} if rank == 0 else {"stdin": subprocess.DEVNULL,
                                       "stdout": 2}   # this process's stderr
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, *flags], env=env,
                **io))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {n} exited with "
                                   f"code {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
