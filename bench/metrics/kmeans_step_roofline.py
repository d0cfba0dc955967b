"""A Lloyd step's share of its roofline: the yardstick's bound of the
segment's calls over the device time of every kernel the port's
nearest-row path launches (the assignment, the fold and the combines)
in the device-only traced segment.  Nothing where no session of it saw
those kernels (a program without that path)."""

KERNELS = ("nearest_assign_kernel", "nearest_fold_kernel",
           "combine_partials")


def read(rec):
    seg = rec.segment
    if seg is None or not seg["calls"]:
        return None
    if not any("nearest_" in name for name in seg["ops"]):
        return None
    t = sum(s for name, s in seg["ops"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return seg["calls"] * rec.call_bound_s / t * 100.0
