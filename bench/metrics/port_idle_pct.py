"""The share of the port-and-profiler segment in which the device is
idle while the host is inside a ``pipeline.call`` span: idle seconds
under port spans over the segment's length
(``port_trace.attribute_idle``).  The rest of the device's idle time is
the client's, outside the port's call.  Nothing without that segment."""
from bench.port_trace import OUTSIDE


def read(rec):
    seg = getattr(rec, "port_profiled", None)
    if not seg or seg["window_s"] <= 0:
        return None
    inside = sum(v for k, v in seg["idle_by_span"].items() if k != OUTSIDE)
    return inside / seg["window_s"] * 100.0
