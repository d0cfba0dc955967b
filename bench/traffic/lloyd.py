"""Lloyd's k-means as its user runs it: one client, each request one
step over every point (one call with the points and the centroids), its
sums and counts read back, the new centroids -- sums over counts; a
cluster left empty keeps its centroid -- written into the same centroid
buffer in place.  Every ``iterations`` steps (the source's 20) a new
clustering starts from k distinct points drawn by the seed, as faiss
starts one.  ``judge`` holds every step's answer to the reference's
intervals given that step's input centroids, or, when that would take
more than ``JUDGE_SECONDS``, a seeded sample of at least ``SAMPLE``
steps, the first and the last among them."""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..data.seeds import host_rng

JUDGE_SECONDS = 60.0
SAMPLE = 16


def lowered_rows(mix: dict, rows: int) -> int:
    return rows


class Client:
    def __init__(self, mix, cfg, inputs, call, probe, seed):
        self.call, self.probe, self.seed = call, probe, seed
        self.every = int(mix["iterations"])
        self.points = inputs["points"]
        k, d = int(cfg["args"]["k"]), int(cfg["args"]["d"])
        self.centroids = torch.empty(k, d, dtype=torch.float32,
                                     device=self.points.device)
        self._reset()

    def _reset(self) -> None:
        self.rng = host_rng(self.seed, 2)
        self.step = 0
        self.inputs = []        # each step's input centroids (host)
        self.answers = []       # each step's answer (host)

    def request(self) -> int:
        n, k = self.points.shape[0], self.centroids.shape[0]
        if self.step % self.every == 0:
            pick = self.rng.choice(n, size=k, replace=False)
            self.centroids.copy_(self.points[torch.as_tensor(
                np.sort(pick), device=self.points.device)])
        out = self.probe(self.call, points=self.points,
                         centroids=self.centroids)
        sums, counts = out["km_sums"], out["km_counts"]
        self.answers.append({"km_sums": sums.cpu().numpy(),
                             "km_counts": counts.cpu().numpy()})
        # the step's input, kept on the host: a device copy a step would
        # grow the card's memory, and its allocations stall the loop; a
        # copy on the CPU too, where ``cpu()`` would alias the buffer the
        # update below overwrites
        self.inputs.append(self.centroids.to("cpu", copy=True).numpy())
        new = sums / counts.clamp(min=1.0)[:, None]
        self.centroids.copy_(torch.where(counts[:, None] > 0, new,
                                         self.centroids))
        self.step += 1
        return n

    def warm_up(self) -> None:
        for _ in range(3):
            self.request()
        self._reset()

    def drop_program(self) -> None:
        self.call = None

    def judge(self, ref, count: int, seed: int) -> dict:
        steps = list(range(min(count, len(self.answers))))
        worst, amb, done = {}, [], 0
        t0 = time.perf_counter()
        order = steps
        if steps:
            rng = host_rng(seed, 3)
            rest = [int(i) for i in rng.permutation(steps[1:-1])] \
                if len(steps) > 2 else []
            order = [steps[0]] + ([steps[-1]] if len(steps) > 1 else []) \
                + rest
        for i in order:
            want = ref.answer({"points": self.points,
                               "centroids": torch.as_tensor(
                                   self.inputs[i], device=self.points.device)})
            amb.append(want["ambiguous"])
            for key, v in ref.errors(self.answers[i], want).items():
                worst[key] = max(worst.get(key, 0.0), v)
            done += 1
            spent = time.perf_counter() - t0
            if done >= SAMPLE and spent / done * len(steps) > JUDGE_SECONDS:
                break
        if amb:
            print(f"judged {done} of {len(steps)} steps; ambiguous points "
                  f"{min(amb):.3e}..{max(amb):.3e} of each step",
                  file=sys.stderr)
        return worst
