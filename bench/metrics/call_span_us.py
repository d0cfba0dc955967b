"""The port's own time for one call: the mean ``pipeline.call`` span
(the lowered callable, from its staging to its return), in the port
segment (tracing on, no profiler; ``port_trace.port_segment``).
Nothing without that segment."""
from bench.port_trace import per_call_us


def read(rec):
    return per_call_us(rec, "pipeline.call")
