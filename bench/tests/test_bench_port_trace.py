"""The port's spans read by the benchmark (``bench/port_trace.py`` and
its five readers): each reader is silent without its segment and right
on a synthetic one; the idle attribution splits a synthetic profiler
trace's idle time among the port's spans exactly, and its launch check
catches clocks that do not line up; on the CPU the whole measurement
runs, comes out correct and leaves tracing off."""
import pytest

from bench import harness, port_trace
from bench.tests.common import ROOT, SMALL_ROWS


def record():
    return harness.Record("c", True, 1.0, 0.1, 1.0, [(0.0, 1e-3, 10)],
                          [1e-6], None, None, 1e-3, 1, 1)


PORT_SEGMENT = {
    "window_s": 0.5, "calls": 10,
    "spans": {"pipeline.call": [0.002, 10], "fused_dag.call": [0.0015, 10],
              "fused_dag.stage": [0.0005, 30],
              "fused_dag.launch": [0.0004, 10],
              "fused_dag.combine": [0.0001, 10]},
    "device": {}}
PORT_EVENTS = dict(PORT_SEGMENT, device={"fused_dag.kernel": [0.019, 10],
                                         "fused_dag.combine": [0.001, 10]})
PORT_PROFILED = {"window_s": 0.5, "busy_s": 0.46, "idle_s": 0.04,
                 "idle_by_span": {"fused_dag.launch": 0.01,
                                  "pipeline.call": 0.005,
                                  port_trace.OUTSIDE: 0.025},
                 "calls": 10, "launches_in_span": 1.0}
WANT = {"call_span_us": 200.0, "stage_span_us": 50.0,
        "launch_span_us": 50.0, "fused_dag_event_roofline": 50.0,
        "port_idle_pct": 3.0}


@pytest.mark.parametrize("name", port_trace.NEW_METRICS)
def test_readers_need_their_segment(name):
    read = harness.reader(name, ROOT)
    rec = record()
    assert read(rec) is None
    rec.port_segment = rec.port_events = rec.port_profiled = None
    assert read(rec) is None
    rec.port_segment = dict(PORT_SEGMENT)
    rec.port_events = dict(PORT_EVENTS)
    rec.port_profiled = dict(PORT_PROFILED)
    assert read(rec) == pytest.approx(WANT[name])
    rec.port_events["device"] = {}
    if name == "fused_dag_event_roofline":
        assert read(rec) is None
    rec.port_segment["calls"] = rec.port_events["calls"] = 0
    if name != "port_idle_pct":
        assert read(rec) is None


BASE = 1_700_000_000_000_000_000


def trace():
    """Device: a copy 0-31 us, the megakernel 33-55, a kernel 59-70 and
    80-100; idle 31-33 (inside fused_dag.launch), 55-59 (pipeline.call's
    own time) and 70-80 (outside any call)."""
    dev = [("gpu_memcpy", "Memcpy HtoD", 0, 31, 1),
           ("kernel", "fused_dag_kernel<1>", 33, 22, 7),
           ("kernel", "other", 59, 11, 8),
           ("kernel", "fdag::combine_partials", 80, 20, 9)]
    host = [("cuda_runtime", "cudaLaunchKernel", 31.5, 1, 7),
            ("cuda_runtime", "cudaLaunchKernel", 56, 1, 8),
            ("cuda_runtime", "cudaLaunchKernel", 79, 0.5, 9)]
    return {"baseTimeNanoseconds": BASE, "traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d,
         "args": {"correlation": k}} for c, n, t, d, k in dev + host]}


def spans(offset_us=0.0):
    """The port's spans on the telemetry's clock, whose ts 0 lies
    ``offset_us`` after the trace's base."""
    tree = [("bench.segment", 0, 100), ("pipeline.call", 10, 50),
            ("fused_dag.stage", 12, 8), ("fused_dag.call", 20, 34),
            ("fused_dag.launch", 30, 10), ("fused_dag.combine", 45, 5),
            ("pipeline.call", 75, 10), ("fused_dag.combine", 78, 3)]
    return [{"name": n, "ts": t - offset_us, "dur": d} for n, t, d in tree]


def epoch(offset_us=0.0):
    """The epoch of the telemetry's ts 0 when it starts ``offset_us``
    after the trace's base."""
    return BASE + int(round(offset_us * 1e3))


def test_idle_goes_to_the_innermost_port_span():
    got = port_trace.attribute_idle(trace(), spans(), epoch())
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(84e-6)
    assert got["idle_s"] == pytest.approx(16e-6)
    # the gap 70-80: 70-75 outside, 75-78 the second call's own time,
    # 78-80 its combine
    assert got["idle_by_span"] == pytest.approx({
        "fused_dag.launch": 2e-6, "pipeline.call": 4e-6 + 3e-6,
        "fused_dag.combine": 2e-6, port_trace.OUTSIDE: 5e-6})
    assert sum(got["idle_by_span"].values()) == pytest.approx(got["idle_s"])
    assert got["calls"] == 2 and got["launches_in_span"] == 1.0
    rec = record()
    rec.port_profiled = got
    pct = harness.reader("port_idle_pct", ROOT)(rec)
    assert pct == pytest.approx(11.0)
    assert pct <= got["idle_s"] / got["window_s"] * 100
    assert "outside pipeline.call 0.000005" in port_trace.idle_line(got)


def test_the_same_spans_on_the_clock_moved_by_the_anchor():
    """Spans stamped on a clock that starts 1 ms later map to the same
    places; an anchor that misses by 25 us puts the launches outside
    their spans, which the check reports."""
    same = port_trace.attribute_idle(trace(), spans(1000.0), epoch(1000.0))
    assert same == port_trace.attribute_idle(trace(), spans(), epoch())
    off = port_trace.attribute_idle(trace(), spans(), epoch(25.0))
    assert off["launches_in_span"] == 0.0


def test_attribution_needs_base_segment_and_device():
    t = trace()
    del t["baseTimeNanoseconds"]
    assert port_trace.attribute_idle(t, spans(), epoch()) is None
    assert port_trace.attribute_idle(trace(), spans()[1:], epoch()) is None
    t = trace()
    t["traceEvents"] = [e for e in t["traceEvents"]
                        if e["cat"] == "cuda_runtime"]
    assert port_trace.attribute_idle(t, spans(), epoch()) is None


def test_measure_on_the_cpu():
    from repro_torch.core import telemetry

    out = port_trace.measure("q6.sf100.scan", 2 ** 31 + 11, 0.2,
                             device="cpu", rows=SMALL_ROWS["q6.sf100.scan"])
    assert out["correct"] is True and out["device"] == "cpu"
    m = out["metrics"]
    assert {"call_span_us", "stage_span_us", "launch_span_us",
            "host_issue_us"} <= set(m)
    # no card: no device time, no profiler segment
    assert not {"fused_dag_event_roofline", "port_idle_pct",
                "fused_dag_roofline", "device_idle_pct"} & set(m)
    assert m["stage_span_us"] + m["launch_span_us"] <= m["call_span_us"]
    assert set(out["windows"]) == {"off", "on"}
    assert out["windows"]["on"]["host_issue_us"] > 0
    seg = out["port_segment"]
    assert seg["spans"]["fused_dag.stage"][1] == 3 * seg["calls"]
    assert out["port_events"]["calls"] > 0
    assert not telemetry.enabled() and telemetry.device_pending() == 0
