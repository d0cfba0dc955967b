"""Data generators, one module per kind (``configs/*.json``'s
``data.kind``): ``make(cfg, rows, seed, device)`` returns the program's
inputs by name, made on ``device`` from ``seed``."""
