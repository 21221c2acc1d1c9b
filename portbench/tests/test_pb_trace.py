"""The traced window's reading: device busy time as the union of its
activity, kernel time by name, idle gaps named by the host's innermost
operator."""
import pytest

from harness.trace import TraceSummary


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
