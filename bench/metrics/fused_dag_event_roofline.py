"""The fused-DAG megakernel's share of its roofline from the port's own
CUDA events: the yardstick's bound of the event segment's calls over the
device time of ``device_span("fused_dag.kernel")`` and
``device_span("fused_dag.combine")`` (their ``*_s`` histograms' sums;
each pair recorded by the C entry point right around its kernel),
every call of the segment in one session.  Nothing without that
segment or those events."""


def read(rec):
    seg = getattr(rec, "port_events", None)
    if not seg or not seg["calls"]:
        return None
    t = sum(s for s, _ in seg["device"].values())
    if t <= 0:
        return None
    return seg["calls"] * rec.call_bound_s / t * 100.0
