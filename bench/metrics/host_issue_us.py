"""The mean host time to issue one call into the port (the lowered
callable, the fused-DAG wrapper, its ctypes launches and the combine's),
timed around the call with no synchronise."""


def read(rec):
    if not rec.issue_s:
        return None
    return sum(rec.issue_s) / len(rec.issue_s) * 1e6
