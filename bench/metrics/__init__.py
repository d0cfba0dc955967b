"""One reader per metric: ``<name>.py``'s ``read(record)`` returns the
metric's value from a ``harness.Record``, or None when the run holds
nothing to read it from (the harness then leaves it out)."""
