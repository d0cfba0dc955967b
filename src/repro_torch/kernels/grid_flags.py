"""The host side of ``csrc/grid_flags.cuh``: flag words and their epochs.

A one-launch kernel that combines across blocks (the filter-folds'
in-kernel combine, the tiled FlatMap's decoupled look-back) has each
block publish 64-bit words that other blocks of the same launch
acquire.  A word holds the launch's epoch and a state in its high half
and a 32-bit value in its low half (``word`` / ``fields``).  ``Flags``
owns the words of one kernel: a buffer per (device, stream), zeroed
once when it is allocated, and an epoch that advances on every launch,
so a word an earlier launch left behind reads as not published and no
launch needs a memset first.  Launches on one stream run in order; a
stream of its own gets buffers of its own.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

EPOCH_BITS = 30                      # gflags::EPOCH_BITS
EMPTY, AGGREGATE, INCLUSIVE = 0, 1, 2
LAST_EPOCH = (1 << EPOCH_BITS) - 1


def word(epoch: int, state: int, value: int) -> int:
    """The 64-bit flag word (as an unsigned int) of ``gflags::word``."""
    if not 0 <= epoch <= LAST_EPOCH or not 0 <= state <= 3:
        raise ValueError(f"epoch {epoch} or state {state} out of range")
    return (((epoch << 2) | state) << 32) | (value & 0xFFFFFFFF)


def fields(w: int) -> Tuple[int, int, int]:
    """(epoch, state, value) of a flag word; the value as unsigned 32 bits."""
    w &= (1 << 64) - 1
    hi = w >> 32
    return hi >> 2, hi & 3, w & 0xFFFFFFFF


class Flags:
    """The flag words of one kernel, per (device, stream), with the epoch
    of the latest launch on each."""

    def __init__(self):
        self._bufs: Dict[Tuple[torch.device, int], list] = {}

    def next(self, dev: torch.device, stream: int, words: int
             ) -> Tuple[int, int]:
        """(pointer, epoch) for a launch on ``stream`` that publishes up to
        ``words`` flags: the epoch advances; a buffer too small is
        replaced by a zeroed one, whose epochs start again at 1, and at
        ``LAST_EPOCH`` the buffer is zeroed and the epochs start again."""
        key = (dev, stream)
        entry = self._bufs.get(key)
        if entry is None or entry[0].numel() < words:
            entry = [torch.zeros(max(words, 1), dtype=torch.int64,
                                 device=dev), 0]
            self._bufs[key] = entry
        if entry[1] == LAST_EPOCH:
            entry[0].zero_()
            entry[1] = 0
        entry[1] += 1
        return entry[0].data_ptr(), entry[1]
