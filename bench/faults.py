"""Faults planted under the timed path, each a stand-in for the
program's lowered callable (``lower(cfg, rows, device) -> call``, as
``harness.run`` takes it), for the tests and ``control.py`` to show the
check fails them:

* ``stale``: every call after the first returns the first call's
  answer (a step that returns its state unchanged);
* ``half``: each call reads the first half of the rows twice, so its
  answer is twice the first half's (half of the batch left out, the
  mean taken over the rest);
* ``altered``: the answer of call ``at`` (``ALTERED_CALL`` unless
  given; after the warm-up, inside the window) is scaled by
  1 + ``ALTERED_BY`` where it is made.

The cells run on one chip, so no exchange between chips can be left out.
"""
from __future__ import annotations

import torch

from . import harness

ALTERED_CALL = 40
ALTERED_BY = 1e-2


def _scaled(out, by: float):
    if isinstance(out, dict):
        return {k: v * by for k, v in out.items()}
    return out * by


def planted(kind: str, at: int = ALTERED_CALL):
    """The ``lower`` of fault ``kind``."""
    def lower(cfg, rows, device):
        call = harness.lower_program(cfg, rows, device)
        if kind == "half":
            h = rows // 2

            def half(**tensors):
                # the first half of the rows in both halves' places: the
                # answer is twice the first half's
                cut = {k: (torch.cat([v[:h], v[:h]]) if v.shape[0] == rows
                           else v) for k, v in tensors.items()}
                return call(**cut)
            return half
        seen = {"n": 0, "first": None}

        def faulty(**tensors):
            out = call(**tensors)
            i = seen["n"]
            seen["n"] += 1
            if kind == "stale":
                if seen["first"] is None:
                    seen["first"] = out
                return seen["first"]
            if kind == "altered" and i == at:
                return _scaled(out, 1.0 + ALTERED_BY)
            return out
        return faulty
    if kind not in ("stale", "half", "altered"):
        raise KeyError(kind)
    return lower


def control(cfg, rows, device):
    """The reference in the next precision below, in the program's
    place (``reference/<program>.py``'s ``control``)."""
    return harness.module("reference", cfg["program"]).control
