"""The package's spans read from a window's Chrome events: device work
matched to its span through the launch call's correlation id, the
nesting and self time, the request readers' medians, a replayed window,
and the span table."""
import pytest

from harness import program_spans as ps


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(cat, name, ts, 5, tid, corr)


def _span(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid)


def _step_events():
    """A GAN step: the critic half's backward launches from the autograd
    engine's thread (tid 2) while the main thread waits in it."""
    return [
        _span("step.spectral", 0, 50),
        _launch(10, 1),
        _x("kernel", "power_iteration", 20, 10, tid=7, corr=1),
        _span("step.critic", 100, 900),
        _span("step.critic.penalty", 200, 100),
        _span("step.critic.backward", 500, 400),
        _span("Optimizer.step#Adam.step", 950, 20),
        _launch(150, 2),
        _x("kernel", "fake_forward", 160, 50, tid=7, corr=2),
        _launch(600, 3, tid=2),
        _x("kernel", "dgrad", 700, 100, tid=7, corr=3),
        _launch(620, 4, tid=2, cat="cuda_driver", name="cuLaunchKernel"),
        _x("gpu_memset", "Memset", 820, 30, tid=7, corr=4),
        _span("step.generator", 1000, 1000),
        _span("step.generator.backward", 1500, 300),
        _launch(1100, 5),
        _x("kernel", "rec_forward", 1200, 300, tid=7, corr=5),
        _launch(1600, 6, tid=2),
        _x("gpu_memcpy", "Memcpy DtoD", 1700, 20, tid=7, corr=6),
        _launch(2500, 7),   # after every span
        _x("kernel", "callback_copy", 2600, 10, tid=7, corr=7),
        _x("kernel", "unmatched", 2700, 10, tid=7, corr=99),
    ]


def test_device_work_belongs_to_the_span_its_launch_starts_in():
    spans = ps.ProgramSpans(_step_events())
    assert ps.per_span_ms(spans, "step.critic") == pytest.approx(0.18)
    assert ps.per_span_ms(spans, "step.generator") == pytest.approx(0.32)
    assert ps.per_span_ms(spans, "step.spectral") == pytest.approx(0.01)
    # launched from thread 2 while the main thread waits in the backward
    backward = spans.named("step.critic.backward")[0]
    assert backward.ops == [(700.0, 800.0), (820.0, 850.0)]
    assert spans.named("step.critic.penalty")[0].ops == []
    assert ps.per_span_ms(spans, "step.critic.update") is None


def test_nesting_self_time_and_torch_annotations():
    spans = ps.ProgramSpans(_step_events())
    assert [s.name for s in spans.spans] == [
        "step.spectral", "step.critic", "step.critic.penalty",
        "step.critic.backward", "step.generator",
        "step.generator.backward"]
    critic = spans.named("step.critic")[0]
    assert critic.parent is None
    assert [c.name for c in critic.children] == ["step.critic.penalty",
                                                 "step.critic.backward"]
    assert spans.named("step.generator.backward")[0].parent.name == \
        "step.generator"
    assert critic.self_us() == pytest.approx(900 - 100 - 400)


def test_a_span_on_another_thread_is_no_parent():
    spans = ps.ProgramSpans([_span("train.chunk", 0, 100, tid=1),
                             _span("train.inputs", 10, 20, tid=2)])
    assert spans.named("train.inputs")[0].parent is None


def _request(t, tid=1, ops=(), host=(0, 0)):
    """A request at ``t``: its forward launches ``ops`` (start, dur) at
    ``t + 10 + j``, its host span runs ``host`` (start, dur) after ``t``."""
    events = [_span("serve.request", t, 1000, tid),
              _span("serve.forward", t + 5, 300, tid),
              _span("serve.host", t + host[0], host[1], tid)]
    for j, (start, dur) in enumerate(ops):
        corr = t + j
        events += [_launch(t + 10 + j, corr, tid),
                   _x("kernel", "stage", t + start, dur, 7, corr)]
    return events


def test_request_readers_take_the_medians():
    events = (
        # ops 100-200, 250-300: idle 50 between them; host ends 700
        _request(0, ops=[(100, 100), (250, 50)], host=(600, 100))
        # ops 100-150, 150-200, 260-300: idle 60; host ends at 500
        + _request(1000, ops=[(100, 50), (150, 50), (260, 40)],
                   host=(400, 100))
        # ops 50-100 and an overlapping 80-120: idle 0; host ends 900
        + _request(2000, ops=[(50, 50), (80, 40)], host=(800, 100)))
    spans = ps.ProgramSpans(events)
    # tails 700 - 300, 500 - 300, 900 - 120 = 400, 200, 780
    assert ps.host_tail_ms(spans) == pytest.approx(0.4)
    assert ps.launch_idle_ms(spans) == pytest.approx(0.05)


def test_a_request_without_forward_work_reads_nothing():
    spans = ps.ProgramSpans(_request(0, host=(600, 100)))
    assert ps.host_tail_ms(spans) is None
    assert ps.launch_idle_ms(spans) is None


def test_a_replayed_window_has_no_step_halves():
    events = [_span("train.chunk", 0, 10000),
              _span("train.inputs", 10, 100),
              _span("graph.replay", 200, 300),
              _launch(250, 1, name="cudaGraphLaunch")]
    events += [_x("kernel", f"k{j}", 400 + 100 * j, 50, 7, 1)
               for j in range(8)]
    events += [_span("train.callback", 9000, 500)]
    spans = ps.ProgramSpans(events)
    for name in ("step.critic", "step.generator"):
        assert ps.per_span_ms(spans, name) is None
    assert ps.host_tail_ms(spans) is None
    assert ps.per_span_ms(spans, "graph.replay") == pytest.approx(0.4)
    assert ps.per_span_ms(spans, "train.chunk") == pytest.approx(0.4)


def test_the_table_places_idle_gaps_in_the_innermost_span():
    events = [_span("train.chunk", 0, 1000),
              _span("train.inputs", 100, 300),
              _launch(50, 1),
              _x("kernel", "a", 60, 40, 7, 1),     # busy 60-100
              _launch(450, 2),
              _x("kernel", "b", 300, 100, 7, 2),   # busy 300-400
              _launch(1500, 3),
              _x("kernel", "c", 2000, 100, 7, 3)]  # busy 2000-2100
    lines = ps.table(ps.ProgramSpans(events))
    assert lines == [
        "span train.chunk: count 1, device ms 0.1400, launches 2, self "
        "host ms 0.7000, idle ms 0.0000",
        "span train.inputs: count 1, device ms 0.0000, launches 0, self "
        "host ms 0.3000, idle ms 0.2000",
        f"span {ps.OUTSIDE}: idle ms 1.6000"]
