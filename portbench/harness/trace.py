"""The traced window: ``torch.profiler`` over CPU and CUDA activity, its
Chrome trace read back, and what the per-layer readers and the
``breakdown`` take from it.

Device activity is every kernel, copy and memset event; ``busy_s`` is the
length of their union (the device ran something), ``window_s`` the host's
clock over the traced window, which starts and ends on a
synchronisation.  An idle gap of the device is named by the innermost
operator the host's busiest thread was running at the gap's middle, or
``between_operators``.  The measured package's own spans in the window,
matched to the device work they launched, are ``spans``
(``program_spans.ProgramSpans``), for the span metrics' readers."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .program_spans import _DEVICE_CATS, ProgramSpans, _merge

__all__ = ["Tracer", "TraceSummary", "function_name"]


class TraceSummary:
    """What one traced window holds: ``kernels`` as ``(name, start_us,
    dur_us)``, ``busy_s``, ``window_s``, the top device operations, the
    longest idle gaps by host operator and the package's ``spans``."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        dev, cpu = [], defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            if cat in _DEVICE_CATS:
                dev.append((e["name"], float(e["ts"]), float(e["dur"]), cat))
            elif cat == "cpu_op":
                cpu[e.get("tid")].append((float(e["ts"]),
                                          float(e["ts"]) + float(e["dur"]),
                                          e["name"]))
        dev.sort(key=lambda r: r[1])
        self.kernels = [(n, ts, dur) for n, ts, dur, c in dev
                        if c == "kernel"]
        spans = _merge([(ts, ts + dur) for _, ts, dur, _ in dev])
        self.busy_s = sum(b - a for a, b in spans) / 1e6
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.kernels:
            by_name[name] += dur / 1e6
        self.kernel_seconds = dict(by_name)
        self.device_ops = sorted(([_short(n), s] for n, s in by_name.items()),
                                 key=lambda r: -r[1])[:10]
        host = max(cpu.values(), key=len) if cpu else []
        host.sort()
        self.idle_gaps = _gaps_by_host_op(spans, host)
        self.spans = ProgramSpans(events)

    def kernel_time(self, *prefixes: str) -> float:
        """Seconds of the kernels whose function name (namespaces, return
        type, template and call arguments left out) starts with one of
        ``prefixes``."""
        return sum(s for n, s in self.kernel_seconds.items()
                   if function_name(n).startswith(prefixes))

    def kernel_count(self, *prefixes: str) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if function_name(n).startswith(prefixes))


def _bare(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def function_name(name: str) -> str:
    """``conv3d64_fwd_kernel`` of ``(anonymous namespace)::
    conv3d64_fwd_kernel(float const*, ...)``."""
    return _bare(name).split("(")[0].split("<")[0].split("::")[-1].strip()


def _short(name: str) -> str:
    return _bare(name)[:64]


def _gaps_by_host_op(spans, host) -> List[list]:
    """The gaps between the device's busy spans, summed by the innermost
    host operator at each gap's middle; the ten longest totals."""
    starts = [s for s, _, _ in host]
    totals: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(spans, spans[1:]):
        mid, name = (a + b) / 2, "between_operators"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 64), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        totals[name] += (b - a) / 1e6
    return sorted(([n, s] for n, s in totals.items()),
                  key=lambda r: -r[1])[:10]


class Tracer:
    """Start and stop the profiler at synchronised boundaries; ``stop``
    returns the window's ``TraceSummary``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[TraceSummary]:
        torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return TraceSummary(events, window)
