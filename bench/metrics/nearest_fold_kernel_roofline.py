"""The column-sliced fold kernel's share of its roofline (the keyed sum
of the points): its least work's bound in the segment's calls over its
device time.  Nothing where the segment did not see it."""
from bench.metrics.kernel_roofline import share


def read(rec):
    return share(rec, "nearest_fold_kernel")
