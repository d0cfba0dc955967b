"""Shared helpers of the benchmark's CPU tests: small tables, runs of a
cell on the CPU through the harness (the look for a card skipped)."""
from __future__ import annotations

import time
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
# rows small enough for the plain CPU path, split as each mix needs
SMALL_ROWS = {"q6.sf100.scan": 12800, "q1.sf100.scan": 12800}


def cpu_run(cell: str, seed: int = 5, seconds: float = 0.2,
            trace: bool = False, lower=None, root: Path = ROOT,
            rows=None) -> dict:
    return harness.run(cell, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       rows=rows or SMALL_ROWS.get(cell, 12800),
                       lower=lower, root=root)


def cells():
    """The cells of BENCHMARK.json."""
    return [w["name"] for w in harness.benchmark(ROOT)["workloads"]]


def workload_files():
    """Every cell with a file, BENCHMARK.json's and those kept for later."""
    return sorted(p.stem for p in (ROOT / "bench" / "workloads").glob("*.json"))
