"""All rows of the window's requests over the window's seconds."""


def read(rec):
    if not rec.requests or rec.window_s <= 0:
        return None
    return sum(r[2] for r in rec.requests) / rec.window_s
