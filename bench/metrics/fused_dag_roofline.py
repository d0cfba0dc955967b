"""The fused-DAG megakernel's share of its roofline: the yardstick's
bound of the segment's calls over the device time of the port's kernels
(the megakernel and its combine) in the device-only traced segment.
Nothing where no session of it saw those kernels."""

KERNELS = ("fused_dag_kernel", "combine_partials")


def read(rec):
    seg = rec.segment
    if seg is None or not seg["calls"]:
        return None
    t = sum(s for name, s in seg["ops"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return seg["calls"] * rec.call_bound_s / t * 100.0
