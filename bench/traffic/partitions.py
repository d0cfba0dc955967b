"""Scans over a table laid out as ``partitions`` equal partitions of
rows: each request calls the pipeline once on each of ``span``
consecutive partitions, starting at a partition drawn from the seed,
issues the calls back to back and reads their answers together.  With
one partition and a span of one, a request is one call over the whole
table."""
from __future__ import annotations

import torch

from ..data.seeds import host_rng


def lowered_rows(mix: dict, rows: int) -> int:
    parts = int(mix["partitions"])
    if rows % parts:
        raise ValueError(f"{rows} rows do not split into {parts} partitions")
    return rows // parts


def starts(mix: dict, seed: int):
    """The first partition of each request, forever: the same sequence
    for the same seed."""
    rng = host_rng(seed, 1)
    top = int(mix["partitions"]) - int(mix["span"]) + 1
    while True:
        yield int(rng.integers(0, top))


def flat(out) -> torch.Tensor:
    if isinstance(out, dict):
        return torch.cat([out[k].reshape(-1) for k in sorted(out)])
    return out.reshape(-1)


class Client:
    def __init__(self, mix, cfg, inputs, call, probe, seed):
        self.mix, self.call, self.probe, self.seed = mix, call, probe, seed
        self.span = int(mix["span"])
        part = lowered_rows(mix, cfg["rows"])
        self.part = part
        self.views = [{k: v[p * part:(p + 1) * part] for k, v in
                       inputs.items()} for p in range(int(mix["partitions"]))]
        self.answers = []
        self._starts = starts(mix, seed)

    def request(self) -> int:
        s = next(self._starts)
        outs = [self.probe(self.call, **self.views[p])
                for p in range(s, s + self.span)]
        self.answers.append((s, torch.stack([flat(o) for o in outs])
                             .cpu().numpy()))
        return self.span * self.part

    def warm_up(self) -> None:
        for _ in range(2):
            self.request()
        self.answers.clear()
        self._starts = starts(self.mix, self.seed)

    def drop_program(self) -> None:
        self.call = None

    def judge(self, ref, count: int, seed: int) -> dict:
        """Every answer against the reference's answer for its
        partition: each compared number, its largest over the answers."""
        want, worst = {}, {}
        for s, vals in self.answers[:count]:
            for j in range(self.span):
                p = s + j
                if p not in want:
                    want[p] = ref.answer(self.views[p])
                for k, v in ref.errors(vals[j], want[p]).items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
