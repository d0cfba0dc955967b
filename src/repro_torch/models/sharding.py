"""Activation-sharding hints, decoupled from model code.

Models call ``hint(x, "data", None, "model", None)`` as the reference's
do.  The port runs on one card, so both hints are the identity until the
distribution slice (ROADMAP §1) gives them a device mesh.
"""
from __future__ import annotations


def hint(x, *spec):
    return x


def hint_first(x, specs):
    return x
