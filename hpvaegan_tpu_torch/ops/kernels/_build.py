"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout,
at first use (never at import).  The digest covers the source, the
``csrc/*.cuh`` headers it may include and the flags, so an edited source
or header rebuilds and an unchanged one is reused.
``nvcc -Xptxas -v`` output (registers, shared memory, spills) is kept
beside the library as ``<name>-<digest>.ptxas.txt``.

Only the sources in the repository are compiled; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "build_all", "load_library",
           "ptxas_report"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    parts = [src.read_bytes()] + [h.read_bytes()
                                  for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = f"{name}-{digest}"
    return src, BUILD_DIR / f"lib{stem}.so", BUILD_DIR / f"{stem}.ptxas.txt"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built.
    Returns None when there is nothing to do, else (process, tmp, lib,
    log)."""
    src, lib, log = _paths(name)
    if lib.is_file():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, log


def _finish(name: str, job) -> None:
    proc, tmp, lib, log = job
    try:
        out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s "
                           f"building {name}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}:\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing


def build_all(names: Iterable[str]) -> None:
    """Build several sources at once: one nvcc process each, all started
    before any is waited for."""
    jobs = []
    try:
        for name in names:
            job = _start(name)
            if job is not None:
                jobs.append((name, job))
    except BaseException:  # stop the nvcc processes already started
        for _, (proc, tmp, _, _) in jobs:
            proc.kill()
            proc.communicate()
            os.unlink(tmp)
        raise
    errors = []
    for name, job in jobs:
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build(name: str) -> Path:
    build_all([name])
    return _paths(name)[1]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]


def ptxas_report(name: str) -> str:
    """nvcc's output for the build of ``name``: the ``-Xptxas -v`` lines
    (registers, shared memory, spills), empty when no build is on disk."""
    log = _paths(name)[2]
    return log.read_text().strip() if log.is_file() else ""
