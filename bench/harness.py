"""One run of one cell: set-up, the measured window, the traced
segment, the check against the plain reference, and the result line.

Everything a cell is made of is found by name (``ROOT/bench/...``):
the cell's file, its configuration, its traffic mix and generator, its
data generator, its program's reference and each metric's reader.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules that may not be loaded in a run: JAX and the JAX
# package ("repro"; the port's "repro_torch" is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the port's behaviour is fixed by the benchmark, not by the caller's
# environment
PROGRAM_ENV = ("REPRO_MEASURE", "REPRO_TIMING_DB", "REPRO_FAULTS",
               "REPRO_FAULTS_SEED", "REPRO_BUCKETING", "REPRO_TRACE",
               "REPRO_CERTIFY", "REPRO_TIMEOUT_S")
PROFILE_SESSIONS = 6          # traced segments tried until one sees kernels
PROFILE_SECONDS = 0.5         # a traced segment's length, at most
PROFILE_REQUESTS = 200        # and its requests, at most


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed build and cache directories inside the checkout."""
    build = root / "build"
    return {"REPRO_TORCH_BUILD_DIR": str(build / "repro_torch"),
            "REPRO_DSE_CACHE": str(build / "bench" / "dse_cache.json"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton")}


# ------------------------------------------------------------- specs
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    metrics: List[dict]      # BENCHMARK.json entries this cell reports


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell ``name`` and the metrics it reports: BENCHMARK.json's
    end-to-end ones without ``trace``, its per-layer ones with it."""
    bench = root / "bench"
    wl = load_json(bench / "workloads" / f"{name}.json")
    cfg = load_json(bench / "configs" / f"{wl['config']}.json")
    mix = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    spec = benchmark(root)
    metrics = [m for m in spec["per_layer" if trace else "end_to_end"]
               if reports(m, name)]
    return Cell(name, wl, cfg, mix, metrics)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module."""
    return importlib.import_module(f"bench.{kind}.{name}")


def reader(name: str, root: Path = ROOT) -> Callable:
    """The reader of metric ``name``: ``bench/metrics/<name>.py``'s
    ``read(record)``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ timing
class Probe:
    """Wraps each call into the port: the host's time to issue it (no
    synchronise).  The first call's shapes are kept for the yardstick."""

    def __init__(self):
        self.reset()
        self.shapes = None

    def reset(self) -> None:
        self.issue_s: List[float] = []

    def __call__(self, fn, **tensors):
        t0 = time.perf_counter()
        out = fn(**tensors)
        self.issue_s.append(time.perf_counter() - t0)
        if self.shapes is None:
            outs = out if isinstance(out, dict) else {"out": out}
            self.shapes = ({k: tuple(v.shape) for k, v in tensors.items()},
                           {k: tuple(v.shape) for k, v in outs.items()})
        return out


@dataclasses.dataclass
class Record:
    """What one run measured, for the metric readers."""

    cell: str
    trace: bool
    setup_s: float
    lower_s: float
    window_s: float
    requests: List[tuple]          # (issued s, done s, rows), window-relative
    issue_s: List[float]           # host issue time of each call
    segment: Optional[dict]        # the device-only traced segment's digest
    host_segment: Optional[dict]   # the host-and-device one's (breakdown)
    call_bound_s: float            # the yardstick's bound of one call
    call_bytes: int
    call_ops: int


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def window(client, seconds: float):
    """The closed loop: requests one after another until ``seconds``
    have passed; the window ends when the request running then ends.
    Returns (requests, window seconds, failed, error text)."""
    reqs, failed, err = [], 0, ""
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        ti = time.perf_counter()
        try:
            rows = client.request()
        except Exception:               # a failed request ends the window
            failed += 1
            err = traceback.format_exc()
            td = time.perf_counter()
            break
        td = time.perf_counter()
        reqs.append((ti - t0, td - t0, rows))
        if td >= end:
            break
    return reqs, td - t0, failed, err


# ---------------------------------------------------------- profiler
def op_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


def _spans(trace: dict) -> tuple:
    dev, host = [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                op_name(str(ev.get("name", ""))))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(span)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver",
                     "python_function", "user_annotation"):
            host.append(span)
    return sorted(dev), sorted(host)


def ranked(d: dict, top: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def innermost(host: list, points: List[float]) -> List[str]:
    """For each time in ``points``, the innermost (the latest begun) host
    operation running then, by one sweep over the host's spans."""
    marks = [(s, 1, i) for i, (s, e, _) in enumerate(host)]
    marks += [(e, 0, i) for i, (s, e, _) in enumerate(host)]
    marks += [(t, 2, -1 - j) for j, t in enumerate(points)]
    active, out = [], [""] * len(points)
    for _, kind, i in sorted(marks):
        if kind == 1:
            active.append(i)
        elif kind == 0:
            active.remove(i)
        else:
            out[-1 - i] = host[active[-1]][2] if active else \
                "host code outside traced operations"
    return out


def digest(trace: dict) -> Optional[dict]:
    """From a profiler trace: the seconds the device was busy (the union
    of its kernels, copies and sets), the seconds of each device
    operation by name, and the idle gaps' seconds by the host operation
    running in the middle of each (the innermost).  None when the trace
    holds no device operation."""
    dev, host = _spans(trace)
    if not dev:
        return None
    busy, ops, gaps = 0.0, {}, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_op: Dict[str, float] = {}
    for (a, b), label in zip(gaps, innermost(host, [(a + b) / 2
                                                    for a, b in gaps])):
        by_op[label] = by_op.get(label, 0.0) + (b - a) / 1e6
    return {"busy_s": busy / 1e6, "ops": ops, "gaps": by_op}


def traced(client, probe, torch, activities) -> Optional[dict]:
    """A short segment of the same traffic under torch.profiler: up to
    PROFILE_SESSIONS sessions until one sees a device operation (a
    session may see none).  Its digest with the segment's length and
    its calls into the port, or None."""
    from torch.profiler import profile

    for _ in range(PROFILE_SESSIONS):
        torch.cuda.synchronize()
        calls = len(probe.issue_s)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REQUESTS):
                client.request()
                if time.perf_counter() - t0 >= PROFILE_SECONDS:
                    break
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            got = digest(load_json(Path(path)))
        if got is not None and got["busy_s"] > 0:
            got["window_s"] = span
            got["calls"] = len(probe.issue_s) - calls
            return got
    return None


# ----------------------------------------------------------------- run
def lower_program(cfg: dict, rows: int, device):
    """The configuration's program (``programs/<program>.py``) at
    ``rows`` rows, through the port's ``lower_pipeline`` (the DSE, the
    megakernel's source) and the build or load of each group's
    library."""
    from repro_torch.core.pipeline import lower_pipeline

    pipe = module("programs", cfg["program"]).pipeline(
        rows, **cfg.get("args", {}))
    call = lower_pipeline(pipe, device=device,
                          cache=os.environ.get("REPRO_DSE_CACHE") or False)
    if device.type == "cuda":
        for g in call.group_calls:
            if hasattr(g, "kernel"):
                g.kernel.library()
    return call


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device=None, rows: Optional[int] = None,
        lower: Optional[Callable] = None, root: Path = ROOT) -> dict:
    """One run of a cell.  ``device`` (default: the card), ``rows`` (a
    smaller table) and ``lower`` (what stands in the program's place:
    ``lower(cfg, rows, device) -> call``) are for the tests and the
    control; the benchmark's runs use none of them."""
    import torch

    cell = load_cell(cell_name, trace, root)
    cfg = dict(cell.config)
    if rows is not None:
        cfg["rows"] = rows
    dev = torch.device("cuda" if device is None else device)
    gen = module("traffic", cell.mix["kind"])
    ref = module("reference", cfg["program"])

    marks = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        marks.append(("context", time.perf_counter()))
    inputs = module("data", cfg["data"]["kind"]).make(cfg, cfg["rows"],
                                                      seed, dev)
    sync(torch, dev)
    marks.append(("data", time.perf_counter()))
    call = (lower or lower_program)(cfg, gen.lowered_rows(cell.mix,
                                                          cfg["rows"]), dev)
    marks.append(("lower", time.perf_counter()))
    lower_s = marks[-1][1] - marks[-2][1]
    probe = Probe()
    client = gen.Client(cell.mix, cfg, inputs, call, probe, seed)
    client.warm_up()
    sync(torch, dev)
    marks.append(("warm-up", time.perf_counter()))
    probe.reset()
    setup_s = time.perf_counter() - t_start
    prev = t_start
    parts = []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f}")
        prev = t
    print(f"set-up {setup_s:.3f} s: " + ", ".join(parts), file=sys.stderr)

    reqs, window_s, failed, err = window(client, seconds)
    sync(torch, dev)
    issue_s = list(probe.issue_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    seg = brk = None
    if trace and dev.type == "cuda" and not failed:
        from torch.profiler import ProfilerActivity as PA
        # the device alone first: tracing the host's operations too slows
        # the host, and the device's idle share with it
        seg = traced(client, probe, torch, [PA.CUDA])
        brk = traced(client, probe, torch, [PA.CPU, PA.CUDA])

    client.drop_program()
    del call
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {}
    if reqs:
        t = time.perf_counter()
        numbers = client.judge(ref, len(reqs), seed)
        print(f"check of {len(reqs)} requests: {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        limits = cell.workload["limits"]
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
    correct = bool(reqs) and not failed and all(
        c["value"] <= c["limit"] for c in checks.values())
    if err:
        print(err, file=sys.stderr)

    work = yardstick.work(ref.ops, *probe.shapes) \
        if probe.shapes else {"bytes": 0, "ops": 0, "bound_s": 0.0}
    rec = Record(cell_name, trace, setup_s, lower_s, window_s, reqs, issue_s,
                 seg, brk, work["bound_s"], work["bytes"], work["ops"])
    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(reqs) + failed,
           "failed": failed, "metrics": metrics,
           "device": describe(torch, dev, peak)}
    if seg is not None:
        out["device"]["busy_s"] = seg["busy_s"]
        out["device"]["window_s"] = seg["window_s"]
    if brk is not None:
        out["breakdown"] = {"device_ops": ranked(brk["ops"]),
                            "idle_gaps": ranked(brk["gaps"])}
    out["checks"] = checks
    return out


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def describe(torch, dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
