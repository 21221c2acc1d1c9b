"""The process group and its collectives (port of
``hpvaegan_tpu/parallel/distributed.py:24-58``; the JAX package's
``jax.distributed`` + XLA collectives become ``torch.distributed``).

``maybe_initialize(enable)`` joins a launch of several processes, one rank
each.  The launch is described as in the JAX package, by explicit
arguments or by the environment (the launcher contract)::

    HPVAEGAN_COORDINATOR=host0:1234 HPVAEGAN_NUM_PROCESSES=2 \\
    HPVAEGAN_PROCESS_ID=<i> python -m hpvaegan_tpu_torch.cli.train_video \\
        --distributed --spmd --mesh-shape 1x2 ...

The JAX package falls back to its cluster auto-detection; the port has
none, so ``--distributed`` without a launcher raises, naming the
variables.  Initialization failures propagate: a run of N processes that
silently trains N single-process runs is worse than one that fails.  A
process group that is already up is used as it is.

The backend is decided once, from the device and the cards:

* NCCL when the ranks run on CUDA and each has a card of its own
  (rank ``i`` takes card ``i % device_count``);
* gloo on the CPU, or when ranks share a card (NCCL refuses two ranks of
  one group on one device).  Gloo's CUDA support differs by collective
  and by version, so under gloo every CUDA tensor travels through host
  memory explicitly (``_staged``): the rule is the backend's, not a
  caught error.

The collectives below are the only ones the port issues
(``parallel/mesh.py``, ``ops/kernels/conv3d_spmd.py``, ``multihost.py``
build on them).  Each waits for its result; a failed or timed-out one
raises, and the group's finite ``timeout`` turns a rank that never joins
into an error instead of a hang.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize", "launcher_env", "choose_backend", "backend",
           "process_index", "process_count", "group_timeout_s",
           "LAUNCHER_VARS", "DEFAULT_TIMEOUT_S", "all_reduce_", "all_gather",
           "broadcast_", "send_recv"]

LAUNCHER_VARS = ("HPVAEGAN_COORDINATOR", "HPVAEGAN_NUM_PROCESSES",
                 "HPVAEGAN_PROCESS_ID")
DEFAULT_TIMEOUT_S = 600.0
_timeout_s = DEFAULT_TIMEOUT_S   # the group's, once maybe_initialize made it

_log = logging.getLogger("hpvaegan_tpu_torch.parallel")


def launcher_env() -> Optional[Tuple[str, int, int]]:
    """``(coordinator, num_processes, process_id)`` from the launcher
    contract, or None when ``HPVAEGAN_COORDINATOR`` is not set."""
    if not os.environ.get(LAUNCHER_VARS[0]):
        return None
    missing = [v for v in LAUNCHER_VARS[1:] if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"{LAUNCHER_VARS[0]} is set but {missing} are not")
    return (os.environ[LAUNCHER_VARS[0]], int(os.environ[LAUNCHER_VARS[1]]),
            int(os.environ[LAUNCHER_VARS[2]]))


def choose_backend(device_type: str, world_size: int,
                   device_count: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device_type == "cuda" and device_count >= world_size:
        return "nccl"
    return "gloo"


def maybe_initialize(enable: bool,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cpu",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group when ``enable`` is set; a no-op otherwise.
    ``device_type`` ("cpu" or "cuda") decides the backend and, on CUDA,
    this rank's card.  Returns ``(process_index, process_count)``."""
    if enable and not dist.is_initialized():
        if coordinator_address is None:
            env = launcher_env()
            if env is None:
                raise RuntimeError(
                    "a process of a launch (--distributed, or a sharded "
                    "sampler) needs a launcher: set "
                    + ", ".join(LAUNCHER_VARS)
                    + " (coordinator host:port, process count, this "
                    "process's id) for every process")
            coordinator_address, num_processes, process_id = env
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        count = torch.cuda.device_count() if device_type == "cuda" else 0
        if device_type == "cuda":
            if count == 0:
                raise RuntimeError("no CUDA device is available for this "
                                   "rank")
            torch.cuda.set_device(process_id % count)
        chosen = choose_backend(device_type, num_processes, count)
        dist.init_process_group(
            chosen, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
        global _timeout_s
        _timeout_s = float(timeout_s)
        _log.info(f"torch.distributed: process {process_id}/{num_processes}"
                  f", backend {chosen}"
                  + (" (ranks share a card: CUDA tensors staged through "
                     "host memory)" if device_type == "cuda"
                     and chosen == "gloo" else ""))
    return process_index(), process_count()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def group_timeout_s() -> float:
    """The seconds after which a collective of the group fails: the
    ``timeout_s`` the group was made with here (``DEFAULT_TIMEOUT_S`` for
    a group made elsewhere)."""
    return _timeout_s


def backend() -> Optional[str]:
    """The default group's backend, None without a group."""
    return str(dist.get_backend()) if dist.is_initialized() else None


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: a host copy of a CUDA tensor under
    gloo, a copy on this rank's card of a host tensor under NCCL, else
    ``t`` itself."""
    name = backend()
    if name == "gloo" and t.is_cuda:
        return t.detach().cpu()
    if name == "nccl" and not t.is_cuda:
        return t.detach().to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the world by default), in place."""
    buf = _staged(t)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (same shape everywhere), in the group's rank
    order, on ``t``'s device."""
    buf = _staged(t.contiguous())
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    return [o.to(t.device) for o in out]


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` into ``t``, in place."""
    buf = _staged(t)
    dist.broadcast(buf, src=src)
    if buf is not t:
        t.copy_(buf)
    return t


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Point-to-point in one batch: each ``(tensor, peer)`` of ``sends``
    goes to global rank ``peer``, each of ``recvs`` is filled, in place,
    from its peer.  All are posted before any is waited for, so a ring
    cannot deadlock.  A peer pair carries at most one tensor each way."""
    ops, back = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, _staged(t.contiguous()), peer))
    for t, peer in recvs:
        buf = _staged(t)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
        if buf is not t:
            back.append((t, buf))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in back:
        t.copy_(buf)
