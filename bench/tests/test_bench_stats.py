"""The harness's arithmetic: the percentile is taken over all requests,
the rate over all rows and the whole window; the window runs until the
request that crosses its end; the yardstick's bytes and operations of
both programs; the result line's schema; and the entry point's refusal
without a card."""
import json
import math

import pytest

from bench import harness, yardstick
from bench.tests.common import ROOT, cpu_run, workload_files


def record(lat_ms, window_s, rows=10):
    reqs, t = [], 0.0
    for ms in lat_ms:
        reqs.append((t, t + ms / 1e3, rows))
        t += ms / 1e3
    return harness.Record("c", False, 1.0, 0.1, window_s, reqs,
                          [1e-6] * len(lat_ms), None, None, 1e-3, 1, 1)


def test_p95_over_all_requests():
    lat = list(range(1, 101))[::-1]         # 100 requests, 1..100 ms
    read = harness.reader("request_p95_ms", ROOT)
    assert read(record(lat, 10.0)) == pytest.approx(95.0)
    assert read(record(lat + [1000.0], 10.0)) == pytest.approx(96.0)
    assert harness.percentile([3.0], 95) == 3.0


def test_rate_is_all_rows_over_the_window():
    read = harness.reader("rows_per_s", ROOT)
    rec = record([1.0] * 50, 2.0, rows=7)   # 50 ms of requests in 2 s
    assert read(rec) == pytest.approx(50 * 7 / 2.0)


def test_window_ends_with_the_request_that_crosses_it():
    class Slow:
        def __init__(self):
            self.n = 0

        def request(self):
            self.n += 1
            t = harness.time.perf_counter()
            while harness.time.perf_counter() - t < 0.02:
                pass
            return 3
    c = Slow()
    reqs, window_s, failed, err = harness.window(c, 0.1)
    assert failed == 0 and len(reqs) == c.n
    assert window_s >= 0.1 and reqs[-1][1] == pytest.approx(window_s)
    assert reqs[-2][1] < 0.1 <= reqs[-1][1]


def test_failed_request_ends_the_window():
    class Bad:
        def request(self):
            raise RuntimeError("planted")
    reqs, _, failed, err = harness.window(Bad(), 1.0)
    assert reqs == [] and failed == 1 and "planted" in err


def columns(config, rows):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    return {c: (rows,) for c in cfg["data"]["columns"]}


def test_q6_bytes_and_operations():
    n = 600_000_000
    ops = harness.module("reference", "tpch_q6").ops
    w = yardstick.work(ops, columns("tpch-q6-sf100", n), {"out": ()})
    assert w["bytes"] == 16 * n + 4 and w["ops"] == 11 * n
    assert w["bound_s"] == pytest.approx(9.6e9 / 3.35e12, rel=1e-6)
    assert w["bound_s"] * 1e3 == pytest.approx(2.866, abs=1e-3)


def test_q1_bytes_and_operations():
    n = 600_000_000
    ops = harness.module("reference", "tpch_q1").ops
    w = yardstick.work(ops, columns("tpch-q1-sf100", n), {"out": (6, 6)})
    assert w["bytes"] == 28 * n + 4 * 36 and w["ops"] == 13 * n
    assert w["bound_s"] * 1e3 == pytest.approx(5.015, abs=1e-3)
    # bytes bound it: 13 operations a row at 67 TFLOP/s are 0.12 ms
    assert w["ops"] / yardstick.F32_FLOPS < w["bytes"] / yardstick.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ["device_idle_pct", "fused_dag_roofline"])
def test_device_readers_need_a_traced_segment(name):
    read = harness.reader(name, ROOT)
    assert read(record([1.0] * 10, 1.0)) is None
    rec = record([1.0] * 10, 1.0)
    rec.segment = {"busy_s": 0.4, "window_s": 0.5, "calls": 10,
                   "ops": {"fused_dag_kernel": 0.02, "copy": 0.001}}
    want = {"device_idle_pct": 20.0, "fused_dag_roofline": 50.0}[name]
    assert read(rec) == pytest.approx(want)
    rec.segment["ops"] = {"copy": 0.001}
    if name == "fused_dag_roofline":
        assert read(rec) is None


@pytest.mark.parametrize("cell", workload_files())
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(cell, trace):
    out = cpu_run(cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    want = {m["name"] for m in harness.load_cell(cell, trace, ROOT).metrics}
    if trace:        # on the CPU no device time: those readers are silent
        want -= {"fused_dag_roofline", "device_idle_pct"}
    assert set(out["metrics"]) == want
    json.dumps(out)


def test_entry_refuses_without_a_card(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import os

    from bench import run
    env = dict(os.environ)
    assert run.main(["--workload", "q6.sf100.scan", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
    assert dict(os.environ) == env


def test_no_jax_loaded_is_checked(monkeypatch):
    import sys
    import types
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "repro.core")
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("x"))
    assert "repro" not in harness.forbidden_modules()


def test_trace_digest():
    """Busy time is the union of device operations; each idle gap goes
    to the innermost host operation running in its middle."""
    ev = [("kernel", "k1(int)", 0, 10), ("kernel", "k2", 30, 10),
          ("kernel", "k1(int)", 35, 10), ("gpu_memcpy", "copy", 100, 5),
          ("cpu_op", "aten::outer", 5, 30), ("cpu_op", "aten::inner", 15, 10),
          ("cuda_runtime", "cudaMemcpyAsync", 40, 10)]
    trace = {"traceEvents": [{"ph": "X", "cat": c, "name": n, "ts": t,
                              "dur": d} for c, n, t, d in ev]}
    got = harness.digest(trace)
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["ops"] == pytest.approx({"k1": 20e-6, "k2": 10e-6,
                                        "copy": 5e-6})
    assert got["gaps"] == pytest.approx(
        {"aten::inner": 20e-6, "host code outside traced operations": 55e-6})
    assert harness.digest({"traceEvents": trace["traceEvents"][4:]}) is None
