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
  Every span record carries an ``id`` unique in the process and, under
  a parent, the parent's ``parent_id``, so the spans of one call group
  together however many calls a trace holds.
* **Device spans** -- ``with device_span("fused_dag.kernel") as ev:``
  hands the launcher a pair of CUDA timing events (``ev.events``, their
  ``cudaEvent_t`` handles), which its C entry point records right
  around the kernel, so the pair times the kernel alone and not the
  host's way to it.  Gated like spans, and besides by
  ``enable(device=False)`` (host spans without event work inside
  them); disabled, it is ``NULL_SPAN``, whose ``events`` are nulls, and
  makes no event.  It never synchronizes: a later device span resolves
  the pairs the card has finished, ``flush_device()`` waits for the
  rest, each into ``observe(name + "_s", seconds)``, so the histogram's
  ``count`` and ``sum`` are the launches and their device time.
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

**One clock.**  Span and event ``ts`` are microseconds since ``_T0``, a
``perf_counter`` reading taken at import.  ``epoch_ns(ts)`` maps a
``ts`` onto the epoch clock (``time.time_ns()``), the clock
torch.profiler's Chrome trace is stamped on (its ``ts`` in microseconds
after its ``baseTimeNanoseconds``), and ``export_trace`` writes
``baseTimeNanoseconds`` = ``epoch_base_ns()``, so both files line up.
The anchor between the two clocks is read when a ``ts`` is mapped, not
once: the epoch clock can be stepped while a process runs (seconds, on a
virtual machine), and the profiler stamps by its reading of it then.

``put_record`` / ``get_record`` is a small gated provenance store the
DSE uses to back ``dse.explain(plan)`` with the full exploration
record (enumerated / pruned-with-reason / ranks / certification).

Everything is thread-safe (one module lock around shared state;
per-thread span stacks are lock-free) and bounded (span/event buffers
cap out and count drops rather than growing without limit).
"""
from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "count", "gauge",
    "observe", "emit", "events", "clear_events", "put_record",
    "get_record", "log_bounds", "LATENCY_BOUNDS_S", "export_trace",
    "metrics_snapshot", "span_log", "device_span", "flush_device",
    "device_pending", "device_enabled", "epoch_ns", "epoch_base_ns",
]

_LOCK = threading.RLock()
_TLS = threading.local()
_T0 = time.perf_counter()
_IDS = itertools.count(1)     # span ids; next() is atomic under the GIL

MAX_SPANS = 200_000
MAX_EVENTS = 100_000
MAX_RECORDS = 1024
MAX_FREE_EVENTS = 4096

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
# device spans recorded and not yet resolved: (name, device index,
# start event, end event); resolved events kept for reuse, by device
_device: List[Tuple[str, int, Any, Any]] = []
_dropped_device = 0
_free_events: Dict[int, List[Any]] = {}
_device_on = True             # enable(device=False) leaves device spans off


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


def enable(device: bool = True) -> None:
    """Turn tracing on; ``device=False`` keeps ``device_span`` the no-op,
    so host spans are read with no event work inside them."""
    global _enabled, _device_on
    _enabled = True
    _device_on = device


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear all recorded telemetry and re-arm env-based enablement."""
    global _enabled, _dropped_spans, _dropped_events, _dropped_device
    global _device_on
    with _LOCK:
        _enabled = None
        _device_on = True
        _spans.clear()
        _dropped_spans = 0
        _device.clear()
        _dropped_device = 0
        _free_events.clear()
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
    events = (None, None)       # as a device span's: no event to record

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
    __slots__ = ("name", "args", "id", "_ts")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.id = next(_IDS)
        self._ts = 0.0

    def set(self, **kv):
        """Attach attributes discovered mid-span (e.g. the winner)."""
        self.args.update(kv)
        return self

    def __enter__(self):
        _stack().append(self)
        # stamped after the span's own bookkeeping, as on exit before
        # it, so a span's time leaves its own cost out
        self._ts = (time.perf_counter() - _T0) * 1e6
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
            "tid": th.ident, "thread": th.name, "id": self.id,
        }
        if st:
            ev["parent"] = st[-1].name
            ev["parent_id"] = st[-1].id
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


def epoch_base_ns() -> int:
    """``_T0`` on the epoch clock as it reads now, in nanoseconds."""
    return time.time_ns() - int(round((time.perf_counter() - _T0) * 1e9))


def epoch_ns(ts_us: float) -> int:
    """A span's or event's ``ts`` (microseconds since ``_T0``) on the
    epoch clock, in nanoseconds: torch.profiler's trace puts the same
    instant at ``(epoch_ns(ts) - baseTimeNanoseconds) / 1e3``.  To map
    many, take ``epoch_base_ns()`` once and add ``ts * 1e3``."""
    return epoch_base_ns() + int(round(ts_us * 1e3))


# ------------------------------------------------------------------
# device spans
# ------------------------------------------------------------------


class _DeviceSpan:
    """A pair of timing events for the launcher to record right around
    its kernel (``events``: their ``cudaEvent_t`` handles), pending from
    the block's end until resolved."""

    __slots__ = ("name", "_key", "_start", "_end", "events")

    def __init__(self, name: str, key: int, start, end):
        self.name = name
        self._key = key
        self._start, self._end = start, end
        self.events = (start.cuda_event, end.cuda_event)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped_device
        with _LOCK:
            if exc_type is not None:
                # the launch failed: the pair times nothing
                _keep(self._key, self._start, self._end)
            elif len(_device) < MAX_SPANS:
                _device.append((self.name, self._key, self._start,
                                self._end))
            else:
                _dropped_device += 1
        return False


def device_enabled() -> bool:
    """Would ``device_span`` make a pair of events now?  A launcher whose
    kernels can be timed only by an eager launch asks before choosing."""
    return bool(_enabled if _enabled is not None else _resolve_enabled()) \
        and _device_on


def device_span(name: str, stream=None):
    """The card's time of the kernel the block launches: a pair of CUDA
    timing events on ``stream`` (a ``torch.cuda.Stream``; default: the
    current device's current stream) that the launcher records,
    pending until a later device span finds it finished or
    ``flush_device()`` waits for it.  Disabled (or
    ``enable(device=False)``) -> ``NULL_SPAN``, and no event is made."""
    if not device_enabled():
        return NULL_SPAN
    import torch

    if stream is None:
        stream = torch.cuda.current_stream()
    key = stream.device_index
    with _LOCK:
        start, end = _take(key, stream), _take(key, stream)
    return _DeviceSpan(name, key, start, end)


def _take(key: int, stream):
    """A timing event of device ``key``: one kept by an earlier pair,
    else one of a finished pending pair (``_reap``), else a new one,
    recorded once on ``stream`` so that its CUDA event exists (torch
    makes it at the first record).  Making an event costs more than
    recording one, and a traced run holds a few events, not one pair
    per launch.  Under ``_LOCK``."""
    free = _free_events.get(key)
    if not free:
        _reap()
        free = _free_events.get(key)
    if free:
        return free.pop()
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _keep(key: int, start, end) -> None:
    free = _free_events.setdefault(key, [])
    if len(free) < MAX_FREE_EVENTS:
        free += (start, end)


def _resolve(name: str, key: int, start, end) -> None:
    _hist(name + "_s", start.elapsed_time(end) / 1e3, LATENCY_BOUNDS_S)
    _keep(key, start, end)


def _reap() -> None:
    """Resolve the pending pairs the card has finished, oldest first, up
    to the first it has not (``query``; no synchronize)."""
    with _LOCK:
        done = 0
        for name, key, start, end in _device:
            if not end.query():
                break
            _resolve(name, key, start, end)
            done += 1
        del _device[:done]


def flush_device() -> int:
    """Resolve every pending device span into ``observe(name + "_s",
    seconds)``, whether tracing is still on or not (the pairs were
    recorded while it was).  Waits for each pair's end event; returns
    the number resolved here (pairs a device span already found
    finished were resolved then)."""
    with _LOCK:
        pending = list(_device)
        _device.clear()
    for *_, end in pending:
        end.synchronize()
    with _LOCK:
        for name, key, start, end in pending:
            _resolve(name, key, start, end)
    return len(pending)


def device_pending() -> int:
    """Device spans recorded and not yet flushed."""
    with _LOCK:
        return len(_device)


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
    _hist(name, value, bounds)


def _hist(name: str, value: float, bounds: Tuple[float, ...]) -> None:
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
    A span's ``args`` carry its ``id`` and ``parent_id``;
    ``baseTimeNanoseconds`` puts ``ts`` 0 on the epoch clock, as a
    torch.profiler trace of the same process does.
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
        for k in ("id", "parent_id"):
            if k in s:
                args[k] = s[k]
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
    doc = {"traceEvents": meta + timed, "displayTimeUnit": "ms",
           "baseTimeNanoseconds": epoch_base_ns()}
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
                        "events": _dropped_events,
                        "device": _dropped_device},
        }
