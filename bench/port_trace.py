#!/usr/bin/env python3
"""The port's own spans and CUDA events on the query call path, read in
two more segments of a cell's traffic.

    python3 bench/port_trace.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card.  One process: set-up as
``bench/run.py``'s, a window of ``--seconds`` with tracing off, the
harness's two profiler segments (``harness.traced``: the device alone,
then host and device), then

* **segment (a)**, the port segment: ``telemetry.enable(device=False)``
  (host spans, no event work inside them), no profiler, the same
  traffic (0.5 s or 200 requests).  Its digest holds each port span's
  seconds and count;
* **the event segment**: the same with ``telemetry.enable()``, then a
  synchronize and ``telemetry.flush_device()``: each device span's
  seconds and count (``<name>_s`` histograms), the pairs recorded by
  the C entry points right around their kernels;
* **segment (b)**, the port-and-profiler segment: host spans as in (a)
  under torch.profiler (host and device), up to ``PROFILE_SESSIONS``
  sessions until one sees the device.  The port's spans are moved onto
  the profiler's timeline through ``telemetry.epoch_base_ns()`` and the
  trace's ``baseTimeNanoseconds``, and each idle second of the card
  goes to the innermost port span running then, or outside
  ``pipeline.call``;

then a window with the host spans on (their cost, against the first
window), and the check of every answer against the plain reference.
Prints the idle attribution on standard error and one JSON line last:
the five readers' metrics (``bench/metrics/``) beside the cell's
per-layer ones, and each window's numbers.  ``harness.run`` takes none
of these segments: ``port_segment``, ``port_profiled_segment`` and the
readers are what it would call after its own two, and ``measure`` goes
once it does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the port's host spans on the query call path, and its device spans
PORT_SPANS = ("pipeline.call", "fused_dag.call", "fused_dag.stage",
              "fused_dag.launch", "fused_dag.combine")
DEVICE_SPANS = ("fused_dag.kernel", "fused_dag.combine")
SEGMENT = "bench.segment"            # the bench's own span around (b)
OUTSIDE = "outside pipeline.call"
KERNELS = ("fused_dag_kernel", "combine_partials")
NEW_METRICS = ("call_span_us", "stage_span_us", "launch_span_us",
               "fused_dag_event_roofline", "port_idle_pct")


# ------------------------------------------------------------ readers
def per_call_us(rec, *names) -> Optional[float]:
    """Segment (a)'s seconds in the port spans ``names``, per
    ``pipeline.call``, in microseconds; None without the segment."""
    seg = getattr(rec, "port_segment", None)
    if not seg or not seg["calls"]:
        return None
    return sum(seg["spans"].get(n, (0.0, 0))[0] for n in names) \
        / seg["calls"] * 1e6


# ------------------------------------------------------------ segments
def requests(client, harness) -> float:
    """The traffic for one segment, as ``harness.traced`` sends it; its
    seconds."""
    t0 = time.perf_counter()
    for _ in range(harness.PROFILE_REQUESTS):
        client.request()
        if time.perf_counter() - t0 >= harness.PROFILE_SECONDS:
            break
    return time.perf_counter() - t0


def span_digest(spans: List[dict], hists: Dict[str, dict],
                window_s: float) -> dict:
    """Each port span's (seconds, count), each device span's (seconds,
    count) from its histogram, the calls (``pipeline.call``), and each
    port span's median and largest microseconds (how the sums
    spread)."""
    out = {n: [0.0, 0] for n in PORT_SPANS}
    durs: Dict[str, List[float]] = {n: [] for n in PORT_SPANS}
    for s in spans:
        if s["name"] in out:
            out[s["name"]][0] += s["dur"] / 1e6
            out[s["name"]][1] += 1
            durs[s["name"]].append(s["dur"])
    dev = {n: [hists[n + "_s"]["sum"], hists[n + "_s"]["count"]]
           for n in DEVICE_SPANS if n + "_s" in hists}
    return {"window_s": window_s, "calls": out["pipeline.call"][1],
            "spans": out, "device": dev,
            "median_max_us": {n: [statistics.median(d), max(d)]
                              for n, d in durs.items() if d}}


def _hists(telemetry) -> Dict[str, dict]:
    return telemetry.metrics_snapshot()["histograms"]


def _delta(after: Dict[str, dict], before: Dict[str, dict]) -> dict:
    out = {}
    for name, h in after.items():
        b = before.get(name, {"sum": 0.0, "count": 0})
        if h["count"] > b["count"]:
            out[name] = {"sum": h["sum"] - b["sum"],
                         "count": h["count"] - b["count"]}
    return out


def port_segment(client, probe, sync, harness, telemetry,
                 device: bool = False) -> Optional[dict]:
    """Segment (a): the port's host spans on, no profiler (``sync()``
    waits for the device); with ``device``, its device spans too (the
    event segment).  Beside the spans, ``issue_us``: the mean host time
    of the same calls timed from outside by ``probe``."""
    sync()
    telemetry.flush_device()
    before, n0 = _hists(telemetry), len(telemetry.span_log())
    issued = len(probe.issue_s)
    telemetry.enable(device=device)
    try:
        window_s = requests(client, harness)
        sync()
        telemetry.flush_device()
    finally:
        telemetry.disable()
    got = span_digest(telemetry.span_log()[n0:],
                      _delta(_hists(telemetry), before), window_s)
    if not got["calls"]:
        return None
    got["issue_us"] = statistics.mean(probe.issue_s[issued:]) * 1e6
    return got


def port_profiled_segment(client, torch, harness, telemetry
                          ) -> Optional[dict]:
    """Segment (b): the port's host spans on under torch.profiler (host
    and device), up to PROFILE_SESSIONS sessions until one sees the
    device; its ``attribute_idle`` digest, or None."""
    from torch.profiler import ProfilerActivity as PA
    from torch.profiler import profile

    for _ in range(harness.PROFILE_SESSIONS):
        torch.cuda.synchronize()
        n0 = len(telemetry.span_log())
        telemetry.enable(device=False)
        try:
            with profile(activities=[PA.CPU, PA.CUDA]) as prof:
                with telemetry.span(SEGMENT):
                    requests(client, harness)
                    torch.cuda.synchronize()
        finally:
            telemetry.disable()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace = harness.load_json(Path(path))
        got = attribute_idle(trace, telemetry.span_log()[n0:],
                             telemetry.epoch_base_ns())
        if got is not None and got["busy_s"] > 0:
            return got
    return None


# ---------------------------------------------------- idle attribution
def _device_ops(trace: dict) -> Tuple[list, Dict[int, str], list]:
    """The trace's device operations (start, end) in microseconds, each
    port kernel's name by its correlation id, and the host's runtime
    calls (start, end, correlation)."""
    dev, ours, runtime = [], {}, []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((s, e))
            name = str(ev.get("name", ""))
            if cat == "kernel" and any(k in name for k in KERNELS):
                ours[corr] = name
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((s, e, corr))
    return sorted(dev), ours, runtime


def attribute_idle(trace: dict, spans: List[dict], t0_ns: int) -> \
        Optional[dict]:
    """Segment (b)'s digest from its profiler trace and the port's spans
    of the same session (``ts`` / ``dur`` in microseconds since the
    telemetry's start, which lies at ``t0_ns`` on the epoch clock):
    the segment's length and the device's busy and idle seconds in it,
    each idle second under the innermost port span running then (or
    ``OUTSIDE`` when no ``pipeline.call`` runs), the calls, and the
    share of the port kernels' launches whose runtime call lies inside
    a ``fused_dag.launch`` or ``fused_dag.combine`` span (1.0 when the
    two clocks agree).  None without ``baseTimeNanoseconds``, the
    segment's span or a device operation."""
    base = trace.get("baseTimeNanoseconds")
    segs = [s for s in spans if s["name"] == SEGMENT]
    dev, ours, runtime = _device_ops(trace)
    if base is None or not segs or not dev:
        return None

    def moved(s) -> Tuple[float, float]:
        t = (t0_ns - base) / 1e3 + s["ts"]
        return t, t + s["dur"]

    s0, s1 = moved(segs[-1])
    port = sorted((moved(s) + (s["name"],)) for s in spans
                  if s["name"] in PORT_SPANS)
    busy, idle, cur = 0.0, [], s0       # the device's union, clipped
    for a, b in dev:
        a, b = max(a, s0), min(b, s1)
        if b <= cur:
            continue
        if a > cur:
            idle.append((cur, a))
        busy += b - max(a, cur)
        cur = b
    if cur < s1:
        idle.append((cur, s1))

    # one sweep: each idle piece goes to the innermost port span open
    # then (spans of one thread nest), or OUTSIDE
    marks = [(a, 1, i) for i, (a, _, _) in enumerate(port)]
    marks += [(b, 0, i) for i, (_, b, _) in enumerate(port)]
    marks += [(a, 3, -1) for a, _ in idle] + [(b, 2, -1) for _, b in idle]
    by: Dict[str, float] = {}
    active: List[int] = []
    idle_on, prev = False, s0
    for t, kind, i in sorted(marks):
        if idle_on and t > prev:
            inside = any(port[j][2] == "pipeline.call" for j in active)
            label = port[active[-1]][2] if inside else OUTSIDE
            by[label] = by.get(label, 0.0) + (t - prev) / 1e6
        prev = max(prev, t)
        if kind == 1:
            active.append(i)
        elif kind == 0:
            active.remove(i)
        else:
            idle_on = kind == 3

    launch = [(a, b) for a, b, n in port
              if n in ("fused_dag.launch", "fused_dag.combine")]
    calls = [(s + e) / 2 for s, e, c in runtime if c in ours]
    inside = sum(any(a <= t <= b for a, b in launch) for t in calls)
    return {"window_s": (s1 - s0) / 1e6, "busy_s": busy / 1e6,
            "idle_s": sum(b - a for a, b in idle) / 1e6,
            "idle_by_span": by,
            "calls": sum(1 for *_, n in port if n == "pipeline.call"),
            "launches_in_span": inside / len(calls) if calls else None}


def idle_line(seg: dict) -> str:
    """The stderr line: idle seconds by innermost port span, and those
    outside any ``pipeline.call``."""
    parts = [f"{k} {v:.6f}" for k, v in sorted(
        seg["idle_by_span"].items(), key=lambda kv: -kv[1])]
    return (f"port idle {seg['idle_s']:.6f} s of {seg['window_s']:.6f} s: "
            + ", ".join(parts))


# ------------------------------------------------------------------ run
def window_numbers(harness, rec) -> dict:
    return {n: harness.reader(n, ROOT)(rec)
            for n in ("rows_per_s", "request_p95_ms", "host_issue_us")}


def measure(workload: str, seed: int, seconds: float, *, device=None,
            rows: Optional[int] = None) -> dict:
    """One run as the module's docstring says.  ``device`` (default:
    the card) and ``rows`` (a smaller table) are for the tests; on the
    CPU the profiler segments and segment (b) are left out."""
    from bench import harness, yardstick
    import torch
    from repro_torch.core import telemetry

    cell = harness.load_cell(workload, True, ROOT)
    cfg = dict(cell.config, **({"rows": rows} if rows else {}))
    dev = torch.device("cuda" if device is None else device)
    gen = harness.module("traffic", cell.mix["kind"])
    ref = harness.module("reference", cfg["program"])
    inputs = harness.module("data", cfg["data"]["kind"]).make(
        cfg, cfg["rows"], seed, dev)
    call = harness.lower_program(
        cfg, gen.lowered_rows(cell.mix, cfg["rows"]), dev)
    probe = harness.Probe()
    client = gen.Client(cell.mix, cfg, inputs, call, probe, seed)
    client.warm_up()

    def sync():
        harness.sync(torch, dev)

    def timed(on: bool):
        sync()
        probe.reset()
        if on:
            telemetry.enable(device=False)
        try:
            reqs, window_s, failed, err = harness.window(client, seconds)
            sync()
        finally:
            telemetry.disable()
        if failed:
            raise RuntimeError(err)
        return reqs, window_s, list(probe.issue_s)

    reqs, window_s, issue_s = timed(False)
    seg = brk = prof = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity as PA
        seg = harness.traced(client, probe, torch, [PA.CUDA])
        brk = harness.traced(client, probe, torch, [PA.CPU, PA.CUDA])
    port = port_segment(client, probe, sync, harness, telemetry)
    events = port_segment(client, probe, sync, harness, telemetry,
                          device=True)
    if dev.type == "cuda":
        prof = port_profiled_segment(client, torch, harness, telemetry)
    on = timed(True)

    work = yardstick.work(ref.ops, *probe.shapes)

    def record(reqs, window_s, issue_s, trace=False):
        return harness.Record(workload, trace, 0.0, 0.0, window_s, reqs,
                              issue_s, seg, brk, work["bound_s"],
                              work["bytes"], work["ops"])

    rec = record(reqs, window_s, issue_s, True)
    rec.port_segment, rec.port_events, rec.port_profiled = \
        port, events, prof
    names = [m["name"] for m in cell.metrics] + list(NEW_METRICS)
    metrics = {n: harness.reader(n, ROOT)(rec) for n in names}
    out_windows = {"off": window_numbers(harness, rec),
                   "on": window_numbers(harness, record(*on))}

    client.drop_program()
    del call
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    count = len(client.answers)
    numbers = client.judge(ref, count, seed)
    limits = cell.workload["limits"]
    return {"correct": all(v <= limits[k] for k, v in numbers.items()),
            "answers": count, "checks": numbers,
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "windows": out_windows,
            "port_segment": port, "port_events": events,
            "port_profiled": prof,
            "idle_gaps": harness.ranked(brk["gaps"]) if brk else None,
            "device": harness.describe(torch, dev, 0)["kind"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.update(harness.cache_env(ROOT))
    for var in harness.PROGRAM_ENV:
        os.environ.pop(var, None)
    out = measure(args.workload, args.seed, args.seconds)
    print(f"set-up and run {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    if out["port_profiled"] is not None:
        print(idle_line(out["port_profiled"]), file=sys.stderr)
    print("profiler idle gaps (by the host operation at each gap's "
          f"middle): {out['idle_gaps']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
