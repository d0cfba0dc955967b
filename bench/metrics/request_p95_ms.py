"""The 95th percentile (nearest rank) of every request's time in the
window, from its issue to its answer on the host."""
from bench.harness import percentile


def read(rec):
    if not rec.requests:
        return None
    return percentile([done - issued for issued, done, _ in rec.requests],
                      95) * 1e3
