"""The measured package's own spans in a traced window, matched to the
device work they launched.

``hpvaegan_tpu_torch`` marks its layers with ``utils/profiling.span``
while a profiler records: ``user_annotation`` events in the same Chrome
trace as the kernels, on the trace's clock.  A span's parent is the
innermost span that encloses it on the same thread.  A device operation
(kernel, copy or memset) belongs to a span when the CUDA API call that
launched it (the ``cuda_runtime`` or ``cuda_driver`` event with its
``correlation`` id) starts inside the span's interval, on whatever
thread: the autograd engine's device thread launches a backward's kernels
while the main thread waits inside ``step.*.backward``.  The kernels a
CUDA graph replays carry the correlation of the graph's launch, so they
belong to ``graph.replay``; nothing inside a replay has a span of its own.

Readers (each None where the window holds nothing to read):

* ``per_span_ms(spans, name)``: the device milliseconds launched inside
  the spans called ``name``, over their number (``critic_ms.train``:
  ``step.critic``; ``generator_ms.train``: ``step.generator``);
* ``host_tail_ms(spans)``: for each ``serve.request``, the end of its
  ``serve.host`` span less the end of the last device operation launched
  inside its ``serve.forward``; the median over the requests;
* ``launch_idle_ms(spans)``: for each request, the interval from the
  first start to the last end of the device operations launched inside its
  ``serve.forward``, less the union of their durations; the median.

``table(spans)`` gives one line a span name: count, device ms launched
inside, device operations, self host ms (the spans' durations less what
their children cover) and the device's idle ms whose gap has its middle
innermost in a span of that name."""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["PACKAGE", "Span", "ProgramSpans", "per_span_ms", "host_tail_ms",
           "launch_idle_ms", "table", "OUTSIDE"]

# the first word of the package's span names (torch names its own
# annotations otherwise, e.g. ``Optimizer.step#Adam.step``)
PACKAGE = ("serve", "gen", "train", "graph", "step")
OUTSIDE = "(no span)"

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as disjoint intervals in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Span:
    """One span: ``name``, ``tid``, ``start`` and ``end`` (us), its
    ``parent`` and ``children``, and ``ops``, the ``(start, end)`` of the
    device operations launched inside it."""

    def __init__(self, name: str, tid, start: float, end: float):
        self.name, self.tid, self.start, self.end = name, tid, start, end
        self.parent: Optional[Span] = None
        self.children: List[Span] = []
        self.ops: List[tuple] = []

    def encloses(self, other: "Span") -> bool:
        return (other.tid == self.tid and self.start <= other.start
                and other.end <= self.end)

    def child(self, name: str) -> Optional["Span"]:
        return next((c for c in self.children if c.name == name), None)

    def device_us(self) -> float:
        return sum(b - a for a, b in self.ops)

    def self_us(self) -> float:
        covered = _merge([(c.start, c.end) for c in self.children])
        return (self.end - self.start) - sum(b - a for a, b in covered)


class ProgramSpans:
    """The package's spans of a window's Chrome events, nested, with the
    device operations each launched; ``busy``: the device's busy
    intervals, every operation's."""

    def __init__(self, events: List[dict]):
        launched: Dict[int, float] = {}
        ops, spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts = e.get("cat"), float(e["ts"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE_CATS:
                ops.append((ts, ts + float(e["dur"]), corr))
            elif cat in _LAUNCH_CATS and corr is not None:
                launched[corr] = ts
            elif (cat == "user_annotation"
                  and e["name"].split(".")[0] in PACKAGE):
                spans.append(Span(e["name"], e.get("tid"), ts,
                                  ts + float(e["dur"])))
        self.busy = _merge([(a, b) for a, b, _ in ops])
        spans.sort(key=lambda s: (s.start, -s.end))
        open_by_tid: Dict[object, List[Span]] = defaultdict(list)
        for s in spans:
            stack = open_by_tid[s.tid]
            while stack and not stack[-1].encloses(s):
                stack.pop()
            if stack:
                s.parent = stack[-1]
                stack[-1].children.append(s)
            stack.append(s)
        self.spans = spans
        self._starts = [s.start for s in spans]
        at = sorted((launched[c], a, b) for a, b, c in ops if c in launched)
        times = [t for t, _, _ in at]
        for s in spans:
            lo = bisect.bisect_left(times, s.start)
            hi = bisect.bisect_right(times, s.end)
            s.ops = [(a, b) for _, a, b in at[lo:hi]]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def innermost(self, t: float) -> Optional[Span]:
        """The span with the latest start among those around ``t``."""
        i = bisect.bisect_right(self._starts, t)
        return next((s for s in reversed(self.spans[:i]) if s.end >= t),
                    None)


def per_span_ms(spans: ProgramSpans, name: str) -> Optional[float]:
    named = spans.named(name)
    if not named:
        return None
    return sum(s.device_us() for s in named) / len(named) / 1e3


def _forward_ops(request: Span) -> List[tuple]:
    forward = request.child("serve.forward")
    return forward.ops if forward is not None else []


def host_tail_ms(spans: ProgramSpans) -> Optional[float]:
    tails = []
    for r in spans.named("serve.request"):
        host, ops = r.child("serve.host"), _forward_ops(r)
        if host is not None and ops:
            tails.append(host.end - max(b for _, b in ops))
    return statistics.median(tails) / 1e3 if tails else None


def launch_idle_ms(spans: ProgramSpans) -> Optional[float]:
    idles = []
    for r in spans.named("serve.request"):
        ops = _forward_ops(r)
        if ops:
            busy = sum(b - a for a, b in _merge(ops))
            idles.append(max(b for _, b in ops) - min(a for a, _ in ops)
                         - busy)
    return statistics.median(idles) / 1e3 if idles else None


def table(spans: ProgramSpans) -> List[str]:
    """One line a span name, in the order names first appear, then the
    idle ms outside every span."""
    rows: Dict[str, dict] = {}
    for s in spans.spans:
        r = rows.setdefault(s.name, {"count": 0, "device_us": 0.0, "ops": 0,
                                     "self_us": 0.0, "idle_us": 0.0})
        r["count"] += 1
        r["device_us"] += s.device_us()
        r["ops"] += len(s.ops)
        r["self_us"] += s.self_us()
    outside = 0.0
    for (_, a), (b, _) in zip(spans.busy, spans.busy[1:]):
        inner = spans.innermost((a + b) / 2)
        if inner is None:
            outside += b - a
        else:
            rows[inner.name]["idle_us"] += b - a
    lines = [f"span {name}: count {r['count']}, device ms "
             f"{r['device_us'] / 1e3:.4f}, launches {r['ops']}, self host "
             f"ms {r['self_us'] / 1e3:.4f}, idle ms {r['idle_us'] / 1e3:.4f}"
             for name, r in rows.items()]
    lines.append(f"span {OUTSIDE}: idle ms {outside / 1e3:.4f}")
    return lines
