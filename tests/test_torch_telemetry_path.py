"""The port's telemetry on the query call path (``repro_torch.core``:
``telemetry`` and the lowered fused pipeline), on the CPU.

Held: with tracing off a lowered pipeline's calls record nothing (no
span, no histogram, no pending device pair) and ``device_span`` is the
shared no-op; with tracing on one call gives a ``pipeline.call`` root
whose children name it by ``parent_id``, ``seq`` counting the
callable's calls; span ids are unique and the parent's name and the
``args`` stay as the reference's span records have them; the clock
maps onto torch.profiler's (its ``baseTimeNanoseconds``) within 50 us;
``export_trace`` writes that base beside the events and still passes
``check_trace.py``; a device span hands its launcher a pair of event
handles, and pending pairs resolve into ``<name>_s`` histograms after
tracing is turned off, from two threads alike; ``enable(device=False)``
traces the host alone.  The card's side (the megakernel's C entry
points recording the pairs) is ``test_torch_cuda.py``'s.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, telemetry
from repro_torch.patterns import analytics as an

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _q6(n=1024):
    pipe, make_inputs, _ = an.PIPELINES["tpchq6"](n=n)
    call = cc.lower_fused_pipeline(pipe, device="cpu", tier=cost.TPU,
                                   cache=False)
    inp = {k: torch.as_tensor(v) for k, v in make_inputs().items()}
    return call, inp


def _state():
    snap = telemetry.metrics_snapshot()
    return (telemetry.span_log(), snap["histograms"], snap["spans"],
            telemetry.device_pending())


def test_tracing_off_records_nothing_on_the_call_path(monkeypatch):
    call, inp = _q6()
    call(**inp)
    telemetry.disable()
    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    before = _state()
    for _ in range(1000):
        call(**inp)
    assert _state() == before == ([], {}, 0, 0)
    assert telemetry.device_span("fused_dag.kernel") is telemetry.NULL_SPAN
    with telemetry.device_span("fused_dag.kernel"):
        pass
    assert made == [] and telemetry.device_pending() == 0


def test_one_call_is_one_tree_linked_by_ids():
    call, inp = _q6()
    call(**inp)                       # call 1, untraced
    telemetry.enable()
    call(**inp)
    call(**inp)
    log = [s for s in telemetry.span_log()
           if s["name"].startswith(("pipeline.", "fused_dag."))]
    roots = [s for s in log if s["name"] == "pipeline.call"]
    assert [r["args"] for r in roots] == [{"pipeline": "tpchq6", "seq": 2},
                                          {"pipeline": "tpchq6", "seq": 3}]
    assert all("parent" not in r and "parent_id" not in r for r in roots)
    for root in roots:
        kids = [s for s in log if s.get("parent_id") == root["id"]]
        assert sorted(s["name"] for s in kids) == ["fused_dag.call",
                                                   "fused_dag.stage"]
        assert all(s["parent"] == "pipeline.call" for s in kids)
        dag = next(s for s in kids if s["name"] == "fused_dag.call")
        # the DAG call's staging, then the wrapper's checks (on the CPU
        # the plain version runs: no launch, no combine)
        grand = [s for s in log if s.get("parent_id") == dag["id"]]
        assert [s["name"] for s in grand] == ["fused_dag.stage"] * 2
        tree = kids + grand
        for s in tree:
            assert root["ts"] <= s["ts"]
            assert s["ts"] + s["dur"] <= root["ts"] + root["dur"] + 1e-3
    ids = [s["id"] for s in telemetry.span_log()]
    assert len(ids) == len(set(ids))


def test_ids_are_fields_not_args():
    telemetry.enable()
    with telemetry.span("dse.explore", pattern="p") as outer:
        with telemetry.span("dse.shortlist"):
            pass
    child, parent = telemetry.span_log()
    assert parent["args"] == {"pattern": "p"} and "args" not in child
    assert child["parent"] == "dse.explore"
    assert child["parent_id"] == parent["id"] == outer.id
    assert child["id"] != parent["id"]


def test_clock_lines_up_with_the_profilers(tmp_path):
    """A ``record_function`` and a telemetry span that end at the same
    line end at the same instant on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function

    telemetry.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with telemetry.span("t"):
                with record_function("rf"):
                    torch.ones(256).sum()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"] - telemetry.epoch_base_ns()
    rfs = sorted((e for e in doc["traceEvents"] if e.get("name") == "rf"),
                 key=lambda e: e["ts"])
    spans = [s for s in telemetry.span_log() if s["name"] == "t"]
    assert len(rfs) == len(spans) == 20
    gaps = [abs(s["ts"] + s["dur"] - base / 1e3 - (r["ts"] + r["dur"]))
            for s, r in zip(spans, rfs)]
    assert statistics.median(gaps) < 50.0, gaps


def test_export_writes_the_base_time_and_ids(tmp_path):
    from repro_torch.core import dse

    telemetry.enable()
    t_ns = time.time_ns()
    dse.explore(an.outerprod()[0], tier=cost.TPU, cache=False)
    path = telemetry.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert abs(doc["baseTimeNanoseconds"] - telemetry.epoch_base_ns()) < 1e6
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    top = next(e for e in spans if e["name"] == "dse.explore")
    assert abs(doc["baseTimeNanoseconds"] + top["ts"] * 1e3 - t_ns) < 1e8
    assert telemetry.epoch_ns(top["ts"]) == pytest.approx(
        doc["baseTimeNanoseconds"] + top["ts"] * 1e3, abs=1e6)
    assert all("id" in e["args"] for e in spans)
    kids = [e for e in spans if e["args"].get("parent") == "dse.explore"]
    assert kids and all(e["args"]["parent_id"] == top["args"]["id"]
                        for e in kids)
    rc = subprocess.run([sys.executable,
                         os.path.join(ROOT, "benchmarks", "check_trace.py"),
                         path], capture_output=True, text=True)
    assert rc.returncode == 0, rc.stdout + rc.stderr


class _Event:
    """Stands in for ``torch.cuda.Event`` on a machine without a card.
    Its handle (``cuda_event``) exists from its first record, as
    torch's does; ``launch`` records a pair by handle, as the C entry
    points do, ``steps`` apart (a pair's time is 1 ms a step);
    ``finished`` says whether the card has reached the events recorded
    so far."""

    clock = 0
    made = 0
    finished = False
    by_handle = {}

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.cuda_event = 0
        _Event.made += 1

    def record(self, stream=None):
        if not self.cuda_event:
            self.cuda_event = 0x1000 + len(_Event.by_handle)
            _Event.by_handle[self.cuda_event] = self
        _Event.clock += 1
        self.t = _Event.clock

    def synchronize(self):
        pass

    def query(self):
        return _Event.finished

    def elapsed_time(self, end):
        return float(end.t - self.t)       # ms

    @staticmethod
    def launch(start, end, steps=0):
        _Event.by_handle[start].record()
        _Event.clock += steps
        _Event.by_handle[end].record()


STREAM = SimpleNamespace(device_index=0)


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made, _Event.finished, _Event.by_handle = 0, False, {}
    return _Event


def test_device_spans_resolve_after_tracing_is_off(events):
    telemetry.enable()
    for _ in range(3):
        with telemetry.device_span("fused_dag.kernel", STREAM) as ev:
            events.launch(*ev.events, steps=2)
        with telemetry.device_span("fused_dag.combine", STREAM) as ev:
            events.launch(*ev.events)
    assert telemetry.device_pending() == 6 and events.made == 12
    assert telemetry.metrics_snapshot()["histograms"] == {}
    telemetry.disable()
    assert telemetry.flush_device() == 6
    assert telemetry.device_pending() == 0 and telemetry.flush_device() == 0
    hist = telemetry.metrics_snapshot()["histograms"]
    assert hist["fused_dag.kernel_s"]["count"] == 3
    assert hist["fused_dag.kernel_s"]["sum"] == pytest.approx(3 * 3e-3)
    assert hist["fused_dag.combine_s"]["count"] == 3
    assert hist["fused_dag.combine_s"]["sum"] == pytest.approx(3 * 1e-3)
    # flushed events are recorded again, not made anew
    telemetry.enable()
    for _ in range(6):
        with telemetry.device_span("x", STREAM) as ev:
            events.launch(*ev.events)
    assert events.made == 12 and telemetry.device_pending() == 6
    telemetry.reset()                   # drops the pending and the kept
    assert telemetry.device_pending() == 0
    # pairs the card has finished are resolved by the next device span,
    # which hands their events on: one pair's events serve them all
    telemetry.enable()
    events.finished = True
    for _ in range(5):
        with telemetry.device_span("x", STREAM) as ev:
            events.launch(*ev.events)
    assert events.made == 14 and telemetry.device_pending() == 1
    assert telemetry.metrics_snapshot()["histograms"]["x_s"]["count"] == 4
    assert telemetry.flush_device() == 1


def test_a_failed_launch_times_nothing(events):
    telemetry.enable()
    with pytest.raises(RuntimeError):
        with telemetry.device_span("fused_dag.kernel", STREAM):
            raise RuntimeError("launch refused")
    assert telemetry.device_pending() == 0
    with telemetry.device_span("fused_dag.kernel", STREAM) as ev:
        events.launch(*ev.events, steps=1)
    assert events.made == 2               # the failed pair's events, kept
    assert telemetry.flush_device() == 1
    assert telemetry.metrics_snapshot()["histograms"][
        "fused_dag.kernel_s"]["sum"] == pytest.approx(2e-3)


def test_host_spans_alone(events):
    """``enable(device=False)``: spans record, device spans are the
    no-op (no event, no handle); ``enable()`` brings them back."""
    telemetry.enable(device=False)
    with telemetry.span("fused_dag.launch"):
        with telemetry.device_span("fused_dag.kernel", STREAM) as ev:
            assert ev is telemetry.NULL_SPAN
            assert ev.events == (None, None)
    assert [s["name"] for s in telemetry.span_log()] == ["fused_dag.launch"]
    assert events.made == 0 and telemetry.device_pending() == 0
    telemetry.enable()
    with telemetry.device_span("fused_dag.kernel", STREAM) as ev:
        events.launch(*ev.events)
    assert events.made == 2 and telemetry.device_pending() == 1


def test_device_spans_from_two_threads(events):
    """Two threads launching under device spans take, keep and resolve
    events (under the lock) without losing a pair."""
    telemetry.enable()
    events.finished = True
    errors = []

    def launches():
        try:
            for _ in range(300):
                with telemetry.device_span("x", STREAM) as ev:
                    assert ev.events[0] != ev.events[1]
                    events.launch(*ev.events)
        except Exception as e:           # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=launches) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    telemetry.flush_device()
    assert telemetry.metrics_snapshot()["histograms"]["x_s"]["count"] == 600
