"""Deterministic synthetic token pipeline, sharded by data-parallel rank
(the reference's ``data/pipeline.py``, a copy the port owns: it is
numpy on the host, and its batches equal the reference's bit for bit).

  * determinism: batch(step) is a pure function of (seed, step) -- a
    restarted job resumes mid-stream with no drift;
  * shard locality: each data-parallel rank materializes only its slice;
  * restart: ``state_dict``/``load_state_dict`` capture the cursor.

The generator is a counter-mode hash (splitmix64 over (seed, step,
position)), so any (rank, step) slice is O(1) addressable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_codebooks: int = 0
    step: int = 0

    def batch_slice(self, step: int, lo: int, hi: int) -> Dict:
        """Rows [lo, hi) of the global batch at ``step``: int32 tokens
        (rows, seq[, n_codebooks]) and the labels, the tokens shifted one
        position left (wrapping)."""
        rows = hi - lo
        cb = max(1, self.n_codebooks)
        idx = (np.uint64(self.seed) * np.uint64(0x100000001B3)
               + np.uint64(step) * np.uint64(1 << 40))
        pos = (np.arange(lo * self.seq_len * cb, hi * self.seq_len * cb,
                         dtype=np.uint64) + idx)
        toks = (_splitmix64(pos) % np.uint64(self.vocab)).astype(np.int32)
        if self.n_codebooks:
            toks = toks.reshape(rows, self.seq_len, cb)
        else:
            toks = toks.reshape(rows, self.seq_len)
        labels = np.roll(toks, -1, axis=1)
        return {"tokens": toks, "labels": labels}

    def next_batch(self, rank: int = 0, world: int = 1) -> Dict:
        if self.global_batch % world:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {world} ranks")
        per = self.global_batch // world
        out = self.batch_slice(self.step, rank * per, (rank + 1) * per)
        self.step += 1
        return out

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
