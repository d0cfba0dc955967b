"""The whole window's share of the roofline: the bound of all the work
its requests asked of the port, over the window (host time included)."""


def read(rec):
    if not rec.issue_s or rec.window_s <= 0:
        return None
    return len(rec.issue_s) * rec.call_bound_s / rec.window_s * 100.0
