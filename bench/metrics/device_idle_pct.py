"""The share of time in which no operation ran on the device: 1 - busy /
length of the device-only traced segment (the same traffic as the
window, right after it).  Nothing where no session of it saw the
device."""


def read(rec):
    seg = rec.segment
    if seg is None or seg["window_s"] <= 0:
        return None
    return (1.0 - seg["busy_s"] / seg["window_s"]) * 100.0
