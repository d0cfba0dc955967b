"""BENCHMARK.json keeps to its contract and agrees with the files it
names; every cell resolves to its configuration, traffic, data,
reference and metric readers by name; and a cell, a configuration, a
traffic mix and a metric added as files only are found without a code
edit."""
import json
import re
import shutil

import pytest

from bench import harness
from bench.tests.common import ROOT, cells, cpu_run, workload_files

SPEC = harness.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for m in METRICS:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in METRICS:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", workload_files())
def test_cell_resolves(cell):
    wl = harness.load_json(ROOT / "bench" / "workloads" / f"{cell}.json")
    assert wl["name"] == cell and NAME.match(cell)
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    cfg = harness.load_json(ROOT / "bench" / "configs"
                            / f"{wl['config']}.json")
    c = harness.load_cell(cell, False, ROOT)
    assert harness.module("traffic", c.mix["kind"]).Client
    assert harness.module("data", cfg["data"]["kind"]).make
    assert harness.module("reference", cfg["program"]).control
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    for trace in (False, True):
        for m in harness.load_cell(cell, trace, ROOT).metrics:
            assert callable(harness.reader(m["name"], ROOT))


@pytest.mark.parametrize("cell", cells())
def test_benchmark_cell_agrees_with_its_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = harness.load_json(ROOT / "bench" / "workloads" / f"{cell}.json")
    assert {k: wl[k] for k in entry} == entry
    cfg_entry = next(c for c in SPEC["configs"] if c["name"] == wl["config"])
    cfg = harness.load_json(ROOT / cfg_entry["file"])
    assert cfg["name"] == cfg_entry["name"]
    assert cfg["reduced"] == cfg_entry["reduced"]
    assert cfg_entry["file"].startswith("bench/configs/")
    # every cell reports setup_s, another end-to-end and a per-layer metric
    e2e = [m["name"] for m in harness.load_cell(cell, False, ROOT).metrics]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.load_cell(cell, True, ROOT).metrics


def test_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_metric_lists_name_cells():
    names = set(cells())
    for m in METRICS:
        assert set(m.get("workloads", names)) <= names


def test_added_files_are_found(tmp_path):
    """A new configuration, traffic mix, cell and metric, each a file of
    its own plus entries in BENCHMARK.json, run without a code edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/tpch-q6-sf100.json").read_text())
    cfg.update(name="tpch-q6-sf1", rows=6000000, scale_factor=1)
    (root / "bench/configs/tpch-q6-sf1.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/quarters.json").write_text(json.dumps(
        {"kind": "partitions", "partitions": 4, "span": 2}))
    wl = {"name": "q6.sf1.quarters", "config": "tpch-q6-sf1",
          "traffic": "quarters", "chips": 1, "why": "a test cell",
          "limits": {"rel_err": 1e-4}}
    (root / "bench/workloads/q6.sf1.quarters.json").write_text(json.dumps(wl))
    (root / "bench/metrics/requests_per_s.py").write_text(
        "def read(rec):\n    return len(rec.requests) / rec.window_s\n")
    spec["configs"].append({"name": "tpch-q6-sf1", "source": "x",
                            "file": "bench/configs/tpch-q6-sf1.json",
                            "reduced": ["rows"], "why": "test"})
    spec["workloads"].append({k: wl[k] for k in
                              ("name", "config", "traffic", "chips", "why")})
    spec["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["q6.sf1.quarters"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = cpu_run("q6.sf1.quarters", root=root, rows=1024)
    assert out["correct"]
    assert set(out["metrics"]) == {"rows_per_s", "request_p95_ms",
                                   "setup_s", "requests_per_s"}
    # a cell already there does not report the new metric
    out = cpu_run("q6.sf100.scan", root=root)
    assert "requests_per_s" not in out["metrics"]
