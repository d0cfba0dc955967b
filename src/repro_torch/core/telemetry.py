"""Process-wide telemetry: tracing spans, a typed metrics registry,
structured event streams, and trace/metrics exporters.

One subsystem, four faces:

* **Spans** -- ``with span("dse.explore", pattern=p.name):`` records a
  wall-clock interval with nesting (per-thread stack) and attached
  attributes.  Spans are *gated*: they exist only when tracing is
  enabled (``REPRO_TRACE=1`` / ``Options(trace=True)``, resolved
  through ``Options.from_env`` like every other tuning option).  When
  disabled, ``span()`` returns a shared no-op singleton -- one global
  check, no allocation, no string formatting -- so instrumentation
  sites cost nothing in production.  Spans time the host: they wrap
  host-side orchestration only and never synchronize the card, so a
  span around a kernel launch measures the launch, not the kernel.
* **Metrics** -- ``count`` / ``gauge`` (always-on: they replace the
  ad-hoc stat dicts of serving and planning) and
  ``observe`` (latency histograms with fixed log-spaced bounds,
  deterministic across runs; gated like spans).
* **Events** -- ``emit(stream, kind, **fields)`` is the single
  structured event stream of the package; ``resilience.EventLog`` is
  a facade over it.
* **Exporters** -- ``export_trace(path)`` writes Chrome trace-event
  JSON (loadable at https://ui.perfetto.dev; each thread in its own
  lane) and ``metrics_snapshot()``
  returns a flat, JSON-able dict of the registry.

``put_record`` / ``get_record`` is a small gated provenance store the
DSE uses to back ``dse.explain(plan)`` with the full exploration
record (enumerated / pruned-with-reason / ranks / certification).

Everything is thread-safe (one module lock around shared state;
per-thread span stacks are lock-free) and bounded (span/event buffers
cap out and count drops rather than growing without limit).
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "count", "gauge",
    "observe", "emit", "events", "clear_events", "put_record",
    "get_record", "log_bounds", "LATENCY_BOUNDS_S", "export_trace",
    "metrics_snapshot", "span_log",
]

_LOCK = threading.RLock()
_TLS = threading.local()
_T0 = time.perf_counter()

MAX_SPANS = 200_000
MAX_EVENTS = 100_000
MAX_RECORDS = 1024

# None = not yet resolved; resolved lazily from Options.from_env() so
# plain REPRO_TRACE=1 runs trace without any code opting in.
_enabled: Optional[bool] = None

_spans: List[Dict[str, Any]] = []
_dropped_spans = 0
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, Dict[str, Any]] = {}
_events: List[Dict[str, Any]] = []
_dropped_events = 0
_records: Dict[Tuple[str, str], Any] = {}


# ------------------------------------------------------------------
# enablement
# ------------------------------------------------------------------


def _resolve_enabled() -> bool:
    global _enabled
    from .options import Options  # local: keep module import-free

    _enabled = bool(Options.from_env().resolved().trace)
    return _enabled


def enabled() -> bool:
    """Is tracing on?  Lazily resolved from ``REPRO_TRACE`` (through
    ``Options.from_env``) on first call; ``enable()``/``disable()``
    override programmatically."""
    if _enabled is None:
        return _resolve_enabled()
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear all recorded telemetry and re-arm env-based enablement."""
    global _enabled, _dropped_spans, _dropped_events
    with _LOCK:
        _enabled = None
        _spans.clear()
        _dropped_spans = 0
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _events.clear()
        _dropped_events = 0
        _records.clear()


# ------------------------------------------------------------------
# spans
# ------------------------------------------------------------------


class _NullSpan:
    """The disabled-mode singleton: every instrumentation site gets
    this same object back, so tracing-off costs one global check and
    zero allocations."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kv):
        return self


NULL_SPAN = _NullSpan()


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


class Span:
    __slots__ = ("name", "args", "_ts")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self._ts = 0.0

    def set(self, **kv):
        """Attach attributes discovered mid-span (e.g. the winner)."""
        self.args.update(kv)
        return self

    def __enter__(self):
        self._ts = (time.perf_counter() - _T0) * 1e6
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped_spans
        dur = (time.perf_counter() - _T0) * 1e6 - self._ts
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        th = threading.current_thread()
        ev: Dict[str, Any] = {
            "name": self.name, "ph": "X",
            "ts": self._ts, "dur": dur,
            "tid": th.ident, "thread": th.name,
        }
        if st:
            ev["parent"] = st[-1].name
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        if self.args:
            ev["args"] = self.args
        with _LOCK:
            if len(_spans) < MAX_SPANS:
                _spans.append(ev)
            else:
                _dropped_spans += 1
        return False


def span(name: str, **attrs):
    """A tracing span context manager.  Disabled -> shared no-op."""
    if not (_enabled if _enabled is not None else _resolve_enabled()):
        return NULL_SPAN
    return Span(name, attrs)


def span_log() -> List[Dict[str, Any]]:
    """Finished spans recorded so far (copies; test/export surface)."""
    with _LOCK:
        return list(_spans)


# ------------------------------------------------------------------
# metrics registry
# ------------------------------------------------------------------


def count(name: str, n: float = 1) -> None:
    """Increment a counter.  Always on: counters replace the ad-hoc
    stat dicts, so they must exist with or without tracing."""
    with _LOCK:
        _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a gauge to its latest value (always on; model-accuracy
    gauges feed the regression gate without tracing enabled)."""
    with _LOCK:
        _gauges[name] = value


def log_bounds(lo: float, hi: float, per_decade: int = 4
               ) -> Tuple[float, ...]:
    """Deterministic log-spaced histogram bounds: ``per_decade`` edges
    per factor of 10 from ``lo`` up to (at least) ``hi``.  Pure
    arithmetic on the arguments -- the same call always returns the
    same tuple, so exported histograms are comparable across runs."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"log_bounds({lo}, {hi}, {per_decade})")
    out = []
    i = 0
    while True:
        edge = lo * 10.0 ** (i / per_decade)
        out.append(edge)
        if edge >= hi:
            break
        i += 1
    return tuple(out)


#: default latency bounds: 1 microsecond .. 100 s, 4 buckets/decade
LATENCY_BOUNDS_S = log_bounds(1e-6, 1e2, per_decade=4)


def observe(name: str, value: float,
            bounds: Tuple[float, ...] = LATENCY_BOUNDS_S) -> None:
    """Record ``value`` into histogram ``name``.  Gated: with tracing
    disabled this returns before touching (or creating) any registry
    entry, so instrumentation-only histograms add zero overhead and
    zero registry growth in production."""
    if not (_enabled if _enabled is not None else _resolve_enabled()):
        return
    with _LOCK:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = {"bounds": tuple(bounds),
                                "counts": [0] * (len(bounds) + 1),
                                "count": 0, "sum": 0.0}
        h["counts"][bisect.bisect_right(h["bounds"], value)] += 1
        h["count"] += 1
        h["sum"] += value


# ------------------------------------------------------------------
# structured event stream
# ------------------------------------------------------------------


def emit(stream: str, kind: str, **fields) -> Dict[str, Any]:
    """Append a structured event to the process-wide stream.  Always
    on (this is the single event sink behind ``resilience.EventLog``)."""
    global _dropped_events
    ev = {"stream": stream, "kind": kind, "t": time.time(),
          "ts": (time.perf_counter() - _T0) * 1e6}
    ev.update(fields)
    with _LOCK:
        if len(_events) < MAX_EVENTS:
            _events.append(ev)
        else:
            _dropped_events += 1
    return ev


def events(stream: Optional[str] = None, **match) -> List[Dict[str, Any]]:
    """Recorded events, optionally filtered by stream and field values."""
    with _LOCK:
        evs = list(_events)
    if stream is not None:
        evs = [e for e in evs if e["stream"] == stream]
    for k, v in match.items():
        evs = [e for e in evs if e.get(k) == v]
    return evs


def clear_events(stream: Optional[str] = None) -> None:
    with _LOCK:
        if stream is None:
            _events.clear()
        else:
            _events[:] = [e for e in _events if e["stream"] != stream]


# ------------------------------------------------------------------
# provenance records (dse.explain backing store)
# ------------------------------------------------------------------


def put_record(kind: str, key: str, payload: Any) -> None:
    """Store a provenance record (bounded LRU).  Gated: provenance is
    recorded only while tracing, matching the spans it summarizes."""
    if not (_enabled if _enabled is not None else _resolve_enabled()):
        return
    with _LOCK:
        _records.pop((kind, key), None)
        _records[(kind, key)] = payload
        while len(_records) > MAX_RECORDS:
            _records.pop(next(iter(_records)))


def get_record(kind: str, key: str) -> Any:
    with _LOCK:
        return _records.get((kind, key))


# ------------------------------------------------------------------
# exporters
# ------------------------------------------------------------------


def export_trace(path: str) -> str:
    """Write everything recorded so far as Chrome trace-event JSON.

    Loadable by https://ui.perfetto.dev or ``chrome://tracing``: spans
    become complete ("X") events with microsecond ``ts``/``dur`` in
    per-thread lanes (thread_name metadata names each lane, so a
    deadline's worker thread is visible next to the main thread),
    structured events become instant ("i") marks.  Timed
    events are sorted by ``ts`` so consumers see monotone timestamps.
    """
    with _LOCK:
        spans = list(_spans)
        evs = list(_events)
    lanes: Dict[Any, int] = {}
    meta: List[Dict[str, Any]] = []

    def lane(raw_tid, name) -> int:
        if raw_tid not in lanes:
            lanes[raw_tid] = len(lanes) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": lanes[raw_tid], "ts": 0,
                         "args": {"name": str(name)}})
        return lanes[raw_tid]

    timed: List[Dict[str, Any]] = []
    for s in spans:
        ev = {"name": s["name"], "ph": "X", "pid": 1,
              "tid": lane(s.get("tid"), s.get("thread", "thread")),
              "ts": s["ts"], "dur": s["dur"]}
        args = dict(s.get("args") or {})
        if s.get("parent"):
            args["parent"] = s["parent"]
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        timed.append(ev)
    for e in evs:
        ev = {"name": f"{e['stream']}.{e['kind']}", "ph": "i",
              "pid": 1, "tid": lane(None, "events"), "ts": e["ts"],
              "s": "p",
              "args": {k: _jsonable(v) for k, v in e.items()
                       if k not in ("stream", "kind", "ts")}}
        timed.append(ev)
    timed.sort(key=lambda ev: ev["ts"])
    doc = {"traceEvents": meta + timed, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def metrics_snapshot() -> Dict[str, Any]:
    """Flat, JSON-able snapshot of the registry: counters, gauges,
    histogram tables, per-stream event counts, span accounting."""
    with _LOCK:
        streams: Dict[str, int] = {}
        for e in _events:
            streams[e["stream"]] = streams.get(e["stream"], 0) + 1
        return {
            "counters": dict(_counters),
            "gauges": {k: _jsonable(v) for k, v in _gauges.items()},
            "histograms": {
                name: {"bounds": list(h["bounds"]),
                       "counts": list(h["counts"]),
                       "count": h["count"], "sum": h["sum"]}
                for name, h in _hists.items()},
            "events": streams,
            "spans": len(_spans),
            "dropped": {"spans": _dropped_spans,
                        "events": _dropped_events},
        }
