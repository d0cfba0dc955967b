"""The share of time in which no operation ran on the device in the
k-means cell: 1 - busy / length of the device-only traced segment, as
``device_idle_pct`` reads it for the TPC-H cells.  Nothing where no
session of it saw the device."""


def read(rec):
    seg = rec.segment
    if seg is None or seg["window_s"] <= 0:
        return None
    return (1.0 - seg["busy_s"] / seg["window_s"]) * 100.0
