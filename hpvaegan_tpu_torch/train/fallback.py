"""The memory ladder shared by the trainers (port of
``hpvaegan_tpu/train/fallback.py``).

When a step runs out of device memory, the next memory mechanism is
turned on and the step is run again:

    (plain) -> --remat -> --gp-chunked -> --remat-blocks

in the JAX package's measured order (``fallback.py:44-60``); once all
three are on, an OOM is raised.  Each rung leaves the result as it was
(``models/remat.py`` recomputes bit for bit; the chunked penalty differs
in the order of its sums only).

On the TPU an HBM OOM is raised at compile time, before any buffer is
touched, so the JAX dispatch only rebuilds its programs.  On the card it
is raised at run time, in the middle of a step, which may by then have
applied the critic's Adam update, moved BatchNorm running statistics and
the spectral vectors, and accumulated gradients.  ``Ladder`` therefore
copies the step's state first (the modules' parameters and buffers, the
optimizers' states, in one multi-tensor copy each way), and on an OOM
puts it back, drops the gradients, frees the failed attempt's memory
and runs the step again on the same inputs: the retried step equals a
step that ran on the new rung from the start.  The iteration's draws are
its inputs (``train/trainer.py`` draws them from ``(seed, scale, it)``
ahead), so the retry consumes the same numbers.

Only ``torch.OutOfMemoryError`` is an OOM (``is_oom``); every other
error propagates at once.  The JAX ``is_hbm_oom`` heuristic for its
remote-compile relay has no counterpart.

Under a mesh an OOM escalates only when every rank ran out of memory in
the same step: the ranks agree in an all-reduce on a gloo group of the
ladder's own (``AGREE_TIMEOUT_S``) before any of them retries.  Equal
shards run out together and all escalate; when one rank alone runs out,
the others wait inside a collective of the step, the agreement times out
on that rank, and the error it raises ends its process, which ends the
others' collectives with an error: the run fails on every rank, and
nothing hangs.
"""
from __future__ import annotations

import datetime
import gc
import logging
from typing import Any, Callable, Iterable, Optional, Sequence

import torch

__all__ = ["is_oom", "escalate", "oom_dispatch", "Ladder",
           "AGREE_TIMEOUT_S"]

# how long a rank that ran out of memory waits for the others to report
# the same (the ranks of one step run out within seconds of each other)
AGREE_TIMEOUT_S = 120.0
_agree_group = None


def is_oom(exc: BaseException) -> bool:
    """Is ``exc`` the card running out of memory?"""
    return isinstance(exc, torch.OutOfMemoryError)


def escalate(cfg) -> Optional[str]:
    """Turn on the next memory rung on ``cfg``; returns its description,
    or None when all three are on already (JAX ``fallback.py:44-60``)."""
    if cfg.remat and cfg.remat_blocks and cfg.gp_chunked:
        return None
    if not cfg.remat:
        cfg.remat = True
        return "rematerialization (--remat)"
    if not cfg.gp_chunked:
        cfg.gp_chunked = True
        return "per-sample gradient penalty (--gp-chunked)"
    cfg.remat_blocks = True
    return "per-block rematerialization (--remat-blocks)"


def _ladder_group():
    """The gloo group of the ranks' agreement, made once a process (every
    rank makes its ladders at the same points, so the collective
    ``new_group`` calls match)."""
    global _agree_group
    if _agree_group is None:
        import torch.distributed as dist
        _agree_group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=AGREE_TIMEOUT_S))
    return _agree_group


def _multi_rank(mesh) -> bool:
    import torch.distributed as dist
    return (mesh is not None and dist.is_initialized()
            and dist.get_world_size() > 1)


class _State:
    """A copy of the tensors a step changes, taken before it and put back
    after a failed attempt.  The list of tensors is rebuilt only when the
    optimizers' states grow (their first step makes them)."""

    def __init__(self, modules: Sequence[torch.nn.Module],
                 optimizers: Sequence[torch.optim.Optimizer]):
        self.modules, self.optimizers = list(modules), list(optimizers)
        self._sizes = None
        self._tensors: list = []
        self._copies: list = []
        self._held: list = []

    @torch.no_grad()
    def save(self) -> None:
        sizes = tuple(len(opt.state) for opt in self.optimizers)
        if sizes != self._sizes:
            tensors = [t for m in self.modules
                       for t in (*m.parameters(), *m.buffers())]
            for opt in self.optimizers:
                for state in opt.state.values():
                    tensors.extend(v for v in state.values()
                                   if isinstance(v, torch.Tensor))
            self._tensors = tensors
            self._copies = [torch.empty_like(t) for t in tensors]
            self._held = [(opt, set(opt.state)) for opt in self.optimizers]
            self._sizes = sizes
        if self._tensors:
            torch._foreach_copy_(self._copies, self._tensors)

    @torch.no_grad()
    def restore(self) -> None:
        for opt, held in self._held:   # state the failed attempt made
            for p in [p for p in opt.state if p not in held]:
                del opt.state[p]
        if self._tensors:
            torch._foreach_copy_(self._tensors, self._copies)
        for m in self.modules:
            m.zero_grad(set_to_none=True)


class Ladder:
    """``ladder(fn, *args, **kwargs)`` runs ``fn`` (a step, or the
    calibration) with the memory ladder: on an OOM it restores the state
    of ``modules`` and ``optimizers``, turns on the next rung of ``cfg``,
    logs it (the JAX wording), calls ``on_escalate()`` (the trainer
    closes its CUDA graph there) and runs ``fn`` again; with every rung
    on, the OOM propagates.  ``cfg`` persists the rungs into later
    scales, as in the JAX package.  ``mesh``: the ranks agree first (see
    the module's docstring)."""

    def __init__(self, cfg, scale_idx: int,
                 modules: Iterable[torch.nn.Module],
                 optimizers: Iterable[torch.optim.Optimizer] = (),
                 mesh=None, on_escalate: Optional[Callable[[], None]] = None):
        self.cfg, self.scale_idx = cfg, scale_idx
        self.mesh, self.on_escalate = mesh, on_escalate
        self._state = _State([m for m in modules if m is not None],
                             [o for o in optimizers if o is not None])
        self.escalations: list = []
        if _multi_rank(mesh):
            _ladder_group()

    def _exhausted(self) -> bool:
        cfg = self.cfg
        return bool(cfg.remat and cfg.gp_chunked and cfg.remat_blocks)

    def __call__(self, fn: Callable, *args, **kwargs) -> Any:
        while True:
            if self._exhausted():
                return fn(*args, **kwargs)
            self._state.save()
            try:
                return fn(*args, **kwargs)
            except torch.OutOfMemoryError:
                pass
            # out of the handler: the failed attempt's frames and their
            # tensors went with the exception
            self._retry()

    def _retry(self) -> None:
        gc.collect()
        if torch.cuda.is_available():
            # the failed attempt's kernels (on a graph's side stream too)
            # end before its memory is freed and its state put back
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if _multi_rank(self.mesh):
            import torch.distributed as dist
            try:
                dist.all_reduce(torch.ones(1), group=_ladder_group())
            except RuntimeError as e:
                raise RuntimeError(
                    f"scale {self.scale_idx}: this rank ran out of device "
                    f"memory and the other ranks did not within "
                    f"{AGREE_TIMEOUT_S:g} s: the ranks cannot climb the "
                    f"memory ladder together") from e
        self._state.restore()
        what = escalate(self.cfg)
        self.escalations.append(what)
        logging.warning(f"scale {self.scale_idx}: step does not fit HBM — "
                        f"enabling {what} and running it again")
        if self.on_escalate is not None:
            self.on_escalate()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def oom_dispatch(cfg, scale_idx: int,
                 rebuild: Callable[[], dict]) -> Callable[..., Any]:
    """The JAX package's form (``fallback.py:63-86``): ``dispatch(name,
    *args)`` runs ``rebuild()[name]`` through a ``Ladder`` without state
    (the steps ``rebuild`` makes hold their own), rebuilding them after
    an escalation."""
    steps = {"all": rebuild()}

    def rebuilt():
        steps["all"] = rebuild()

    ladder = Ladder(cfg, scale_idx, (), on_escalate=rebuilt)

    def dispatch(name: str, *args, **kwargs) -> Any:
        return ladder(lambda: steps["all"][name](*args, **kwargs))

    return dispatch
