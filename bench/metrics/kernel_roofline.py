"""Shared by the per-kernel roofline readers of the k-means cell: one
kernel's share of its roofline, the yardstick's bound of its work in the
segment's calls (its operations and bytes from the reference's
``kernel_work``) over its device time in the device-only traced
segment."""
from bench import harness, yardstick


def share(rec, kernel: str):
    seg = rec.segment
    if seg is None or not seg["calls"]:
        return None
    t = sum(s for name, s in seg["ops"].items() if kernel in name)
    if t <= 0:
        return None
    cell = harness.load_cell(rec.cell, True)
    cfg = cell.config
    ref = harness.module("reference", cfg["program"])
    ops, nbytes = ref.kernel_work(int(cfg["rows"]), int(cfg["args"]["k"]),
                                  int(cfg["args"]["d"]))[kernel]
    return seg["calls"] * yardstick.bound_s(nbytes, ops) / t * 100.0
