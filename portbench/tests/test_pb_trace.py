"""The traced window's reading: device busy time as the union of its
activity, kernel time by name, idle gaps named by the host's innermost
operator, and the package's spans it holds; a window recorded on the
card reads as the harness read it before it held the spans."""
import gzip
import hashlib
import json
from pathlib import Path

import pytest

from harness import program_spans as ps
from harness.cells import reader
from harness.trace import TraceSummary

DATA = Path(__file__).parent / "data"


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_busy_gaps_and_kernels():
    events = [
        _x("kernel", "void conv3d64_fwd_kernel(float const*)", 0, 100),
        _x("kernel", "conv3d64_dw_partial(float const*)", 50, 100),
        _x("gpu_memcpy", "Memcpy DtoH", 300, 50),
        _x("kernel", "sm80_xmma_gemm", 1000, 10),
        _x("cpu_op", "aten::step", 0, 2000),
        _x("cpu_op", "aten::copy_", 200, 80),
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    tr = TraceSummary(events, window_s=0.002)
    assert tr.busy_s == pytest.approx((150 + 50 + 10) / 1e6)
    assert tr.kernel_time("conv3d64_fwd_", "conv3d64_dw_") == pytest.approx(
        200 / 1e6)
    assert tr.kernel_count("conv3d64_") == 2
    assert len(tr.kernels) == 3
    gaps = dict((n, s) for n, s in tr.idle_gaps)
    # the gap 150-300 has its middle in aten::copy_, 350-1000 in aten::step
    assert gaps["aten::copy_"] == pytest.approx(150 / 1e6)
    assert gaps["aten::step"] == pytest.approx(650 / 1e6)
    assert tr.device_ops[0][0].startswith("conv3d64_")


# data/window_events.json.gz: on an H100, one eager GAN step of
# hpvaegan3d.train_s9 at the CPU tests' tiny size (its events cut to the
# step's host interval and the device work launched inside it) and a
# traced window of three requests of hpvaegan3d.sample_s9 at that size,
# stripped to the keys the harness reads; data/window_expected.json: the
# harness as it was before ``TraceSummary`` held the spans, on the same
# events, ``tools/spans.py``'s span readers included
with gzip.open(DATA / "window_events.json.gz", "rt") as _f:
    WINDOWS = json.load(_f)
EXPECTED = json.loads((DATA / "window_expected.json").read_text())
SPAN_METRICS = {"critic_ms": "critic_ms.train",
                "generator_ms": "generator_ms.train",
                "host_tail_ms": "host_tail_ms.sample",
                "launch_idle_ms": "launch_idle_ms.sample"}


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_a_recorded_window_reads_as_before(window):
    w, want = WINDOWS[window], EXPECTED[window]
    tr = TraceSummary(w["events"], w["window_s"])
    assert len(tr.kernels) == want["kernels"]
    assert hashlib.sha256(json.dumps(tr.kernels).encode()).hexdigest() \
        == want["kernels_sha256"]
    assert tr.busy_s == want["busy_s"] and tr.window_s == want["window_s"]
    assert tr.device_ops == want["device_ops"]
    assert tr.idle_gaps == want["idle_gaps"]
    kind = "train" if window.startswith("train") else "sample"
    run = type("Run", (), {"kind": kind, "trace": tr})()
    for value, metric in SPAN_METRICS.items():
        got = reader(metric)(run) if metric.endswith(kind) else None
        assert got == want[value], metric
    assert any(want[v] is not None for v, m in SPAN_METRICS.items()
               if m.endswith(kind))
    assert ps.per_span_ms(tr.spans, "step.critic") == want["critic_ms"]
