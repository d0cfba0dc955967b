"""Joint tile-size and fusion exploration for pipelines (paper §4).

    "In future work, tile sizes for all pattern dimensions will instead
     be determined by the compiler through automated tile size selection
     using modeling and design space exploration."  (paper, §4)

This is the analytic part of the JAX reference's ``dse``: for a
pipeline DAG it enumerates streaming tile candidates (divisors of the
shared extent on the lane/sublane floor) crossed with the metapipeline
buffer depths, prices each fully fused candidate with the traffic and
metapipeline models under one hardware ``cost.Tier``, prunes what busts
the on-chip budget (the paper's BRAM-capacity compile check; on the
GPU the shared memory one block may use), and -- when nothing fused
fits -- splits the DAG at its cheapest contiguous topological cuts by a
prefix DP.  Pricing is uncalibrated: datasheet bandwidth.

Handed ``cost.TPU`` it reproduces the reference's plans exactly; by
default it plans for the card a run is on (``cost.device_tier``).  The
tuning runtime around the reference's DSE (the tuning cache, measured
``top_k`` mode, shape buckets, quarantine and certification) is not
part of this port yet; asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import ir
from . import pipeline as plmod
from .cost import Tier, device_tier, stream_seconds
from .memory import plan_memory
from .scheduling import build_schedule, model_speedup

MXU = 128     # lane-count floor of a tile (the reference's MXU edge)
SUBLANE = 8   # fp32 row multiple of a minimum tile

# cap on priced candidates per exploration; the axis is thinned
# (keeping its endpoints) until it fits
MAX_POINTS = 4096

# metapipeline buffer depths enumerated per candidate (2 = the classic
# double buffer); deeper rotating buffers charge ``depth x`` on-chip
# bytes, so they compete with bigger tiles under the budget
DEPTHS = (2, 3, 4)

TUNING_RUNTIME = ("cache", "measure", "top_k", "timing_db", "profile",
                  "warmup", "repeat", "policy", "bucketing", "options")

# min-tile row (sublane) multiples per dtype: the fp32 8-row tile
# becomes 16 rows for bf16/f16 and 32 for int8/fp8 (packed sublanes)
_DTYPE_SUBLANE = {
    "bfloat16": 16, "float16": 16, "half": 16,
    "int8": 32, "uint8": 32,
    "float8_e4m3fn": 32, "float8_e5m2": 32, "float8_e4m3b11fnuz": 32,
}


def dtype_sublane(dtype) -> int:
    """Sublane (row) alignment for a dtype's minimum tile."""
    return _DTYPE_SUBLANE.get(str(dtype), SUBLANE)


def _refuse_tuning_runtime(tuning: Dict) -> None:
    asked = sorted(k for k, v in tuning.items() if v is not None)
    unknown = sorted(set(tuning) - set(TUNING_RUNTIME))
    if unknown:
        raise TypeError(f"unexpected arguments {unknown}")
    if asked:
        raise NotImplementedError(
            f"{asked}: the tuning runtime (tuning cache, measured top_k "
            "mode, buckets, quarantine) arrives with the port's "
            "tuning-runtime slice; this DSE is analytic only")


def axis_candidates(extent: int, align: int = MXU, *,
                    sublane: int = 1) -> List[int]:
    """Divisors of ``extent`` that are multiples of both
    ``min(align, extent)`` and the dtype ``sublane``, falling back to
    the full extent (which is always a candidate)."""
    floor = min(align, extent)
    divs: List[int] = []
    d = 1
    while d * d <= extent:
        if extent % d == 0:
            divs.append(d)
            if d != extent // d:
                divs.append(extent // d)
        d += 1
    out = sorted(c for c in divs
                 if c == extent
                 or (c % floor == 0 and c % sublane == 0))
    return out or [extent]


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Joint DSE result for a pipeline DAG: streaming tiles plus the
    fusion grouping.

    ``groups`` are contiguous ``[start, end)`` ranges over the
    pipeline's *topological* stage order; a single group spanning the
    whole DAG means fully fused (intermediates stay on chip).  More
    than one group is the split fallback: every intermediate crossing a
    group boundary round-trips main memory, and each group carries its
    own streaming tile in ``group_blocks``.  ``depths`` (parallel to
    ``group_blocks``) records each group's metapipeline buffer depth.
    ``block`` / ``depth`` are the first group's values.  The JSON form
    is the reference's, so a plan carries across the two packages.
    """

    block: int
    groups: Tuple[Tuple[int, int], ...]
    traffic_words: int            # fused plan: main-memory reads + writes
    unfused_traffic_words: int    # every intermediate round-trips
    vmem_bytes: int               # max per-group on-chip footprint
    modeled_seconds: float
    group_blocks: Tuple[int, ...] = ()
    explored: int = 0
    pruned: int = 0
    cached: bool = False
    measured: bool = False
    measured_seconds: float = 0.0
    timed: int = 0
    depths: Tuple[int, ...] = ()
    key: str = ""

    def __post_init__(self):
        if not self.group_blocks:
            object.__setattr__(self, "group_blocks",
                               (self.block,) * len(self.groups))
        if not self.depths:
            object.__setattr__(self, "depths", (2,) * len(self.groups))

    @property
    def depth(self) -> int:
        return self.depths[0] if self.depths else 2

    @property
    def fused(self) -> bool:
        return len(self.groups) == 1

    @property
    def traffic_ratio(self) -> float:
        """Unfused / fused main-memory words (>= 1: the fusion win)."""
        return self.unfused_traffic_words / max(self.traffic_words, 1)

    def to_json(self) -> Dict:
        return {
            "block": int(self.block),
            "groups": [list(g) for g in self.groups],
            "group_blocks": [int(b) for b in self.group_blocks],
            "depths": [int(d) for d in self.depths],
            "traffic_words": int(self.traffic_words),
            "unfused_traffic_words": int(self.unfused_traffic_words),
            "vmem_bytes": int(self.vmem_bytes),
            "modeled_seconds": float(self.modeled_seconds),
            "explored": int(self.explored),
            "pruned": int(self.pruned),
            "measured": bool(self.measured),
            "measured_seconds": float(self.measured_seconds),
            "timed": int(self.timed),
            "key": str(self.key),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "PipelinePlan":
        return cls(block=int(d["block"]),
                   groups=tuple(tuple(g) for g in d["groups"]),
                   group_blocks=tuple(int(b)
                                      for b in d.get("group_blocks", ())),
                   depths=tuple(int(x) for x in d.get("depths", ())),
                   traffic_words=int(d["traffic_words"]),
                   unfused_traffic_words=int(d["unfused_traffic_words"]),
                   vmem_bytes=int(d["vmem_bytes"]),
                   modeled_seconds=float(d["modeled_seconds"]),
                   explored=int(d.get("explored", 0)),
                   pruned=int(d.get("pruned", 0)),
                   measured=bool(d.get("measured", False)),
                   measured_seconds=float(d.get("measured_seconds", 0.0)),
                   timed=int(d.get("timed", 0)),
                   key=str(d.get("key", "")),
                   cached=True)


def _pipeline_candidates(pipe) -> List[int]:
    sub = max(dtype_sublane(s.dtype) for s in plmod.topo_stages(pipe))
    cands = axis_candidates(pipe.shared_extent, MXU, sublane=sub)
    while len(cands) > MAX_POINTS and len(cands) > 2:
        cands = (cands[::2] if cands[-1] == cands[::2][-1]
                 else cands[::2] + [cands[-1]])
    return cands


def _price_pipeline_group(sub_pipe, b: int, *, vmem_budget: int, tier: Tier,
                          counters: Dict[str, int], depth: int = 2):
    """Price the sub-pipeline fused at tile ``b`` with stage-buffer
    ``depth``: returns ``(words, onchip_bytes, analytic_s,
    calibrated_s, steps)`` or None when it busts the budget or cannot
    fuse.  Uncalibrated, ``calibrated_s`` is the analytic time."""
    budget_words = max(vmem_budget // 4, 1)
    try:
        fdag = plmod.fuse_dag(sub_pipe, b, vmem_budget_words=budget_words)
    except (ValueError, NotImplementedError):
        return None
    counters["explored"] += 1
    mem = plan_memory(fdag.patterns, vmem_budget_bytes=vmem_budget,
                      depth=depth)
    if not mem.fits:
        counters["pruned"] += 1
        return None
    for t in fdag.patterns:   # streaming fallback left in place
        for q in ir.walk(t):
            for a in q.accesses:
                if isinstance(a.src, ir.Tensor) and a.affine:
                    counters["pruned"] += 1
                    return None
    reads = sum(plmod.dag_external_reads(fdag).values())
    out_w = plmod.output_words(sub_pipe)
    seconds = stream_seconds(reads + out_w, tier=tier)
    # time ratio: most conservative terminal schedule of the kernel
    # (pipe/seq < 1 is overlap speedup, > 1 exposed-latency slowdown)
    ratios = []
    for t in fdag.patterns:
        mp = build_schedule(t, budget_words, depth=depth)
        if mp is not None:
            body_words = sum(s.words for s in mp.stages
                             if s.kind in ("body", "compute"))
            seq, pipe, _ = model_speedup(
                mp, flops_per_body=body_words * 100.0, tier=tier)
            if seq > 0 and pipe > 0:
                ratios.append(pipe / seq)
    if ratios:
        seconds *= max(ratios)
    steps = int(fdag.grid)
    # the uncalibrated seam: the reference prices the stream's bytes
    # (seconds x bandwidth) over datasheet bandwidth again.  The round
    # trip is not the identity in floating point, and keeping it makes
    # the modeled seconds agree bitwise; a measured profile takes its
    # place with the tuning-runtime slice
    stream_bytes = seconds * tier.hbm_bytes_per_s
    calibrated = stream_bytes / tier.hbm_bytes_per_s
    return (reads + out_w, mem.total_bytes, seconds, calibrated, steps)


def _price_whole_pipeline(pipe, *, vmem_budget: int, tier: Tier,
                          counters: Dict[str, int]) -> List[Tuple]:
    """Every feasible fully fused (block, depth) candidate, priced and
    sorted best-first.  Entries are ``((block, depth), (words, vmem,
    s_ana, s_cal, steps))``; ties break toward the shallowest depth."""
    n_stages = len(plmod.topo_stages(pipe))
    try:
        whole = plmod.sub_pipeline(pipe, 0, n_stages)
    except (ValueError, NotImplementedError):
        return []
    priced = []
    for b in _pipeline_candidates(pipe):
        for d in DEPTHS:
            res = _price_pipeline_group(whole, b, vmem_budget=vmem_budget,
                                        tier=tier, counters=counters,
                                        depth=d)
            if res is not None:
                priced.append(((b, d), res))
    priced.sort(key=lambda t: (t[1][0], t[1][3], t[0][1], -t[1][1]))
    return priced


def explore_pipeline(pipe, *, tier: Optional[Tier] = None,
                     vmem_budget: Optional[int] = None,
                     device=None, **tuning) -> PipelinePlan:
    """Joint design-space exploration for a pattern pipeline DAG.

    One tile candidate set is enumerated for the shared streaming
    domain and crossed with the buffer ``DEPTHS``; each (block, depth)
    prices the *fused* megakernel across the whole terminal set
    (external traffic, fan-out tiles and stages charged once, plus
    metapipeline overlap and the exposed load latency at that depth),
    with ``depth x`` on-chip bytes charged per stage buffer.  Ties break
    toward the shallowest depth.  When no fused candidate fits, the DAG
    is split into contiguous topological groups at the cheapest cuts
    (prefix DP, fewer groups on ties), each group with its own block
    and depth.

    ``tier`` defaults to the tier of ``device`` (the card, CUDA unless
    said otherwise); ``vmem_budget`` defaults to the tier's on-chip
    bytes.  The reference's tuning-runtime arguments raise
    ``NotImplementedError``.
    """
    _refuse_tuning_runtime(tuning)
    if tier is None:
        from ..device import resolve
        tier = device_tier(resolve(device))
    vmem_budget = tier.onchip_bytes if vmem_budget is None else vmem_budget

    topo = plmod.topo_stages(pipe)
    n_stages = len(topo)
    cands = _pipeline_candidates(pipe)
    counters = {"explored": 0, "pruned": 0}

    # the fully fused (whole-range) candidates seed the DP's (0, n) entry
    priced_whole = _price_whole_pipeline(
        pipe, vmem_budget=vmem_budget, tier=tier, counters=counters)

    def best_group(i0: int, i1: int, memo: Dict):
        """Per-group (block, depth) choice: cheapest (words, seconds,
        depth, -vmem) for topo stages [i0, i1)."""
        if (i0, i1) in memo:
            return memo[(i0, i1)]
        best = None
        try:
            sub_pipe = plmod.sub_pipeline(pipe, i0, i1)
        except (ValueError, NotImplementedError):
            sub_pipe = None   # e.g. a cut making a terminal also consumed
        if sub_pipe is not None:
            for b in cands:
                for d in DEPTHS:
                    priced = _price_pipeline_group(
                        sub_pipe, b, vmem_budget=vmem_budget, tier=tier,
                        counters=counters, depth=d)
                    if priced is None:
                        continue
                    rank = (priced[0], priced[3], d, -priced[1])
                    if best is None or rank < (best[0], best[1],
                                               best[4], -best[2]):
                        best = (priced[0], priced[3], priced[1], b, d)
        memo[(i0, i1)] = best
        return best

    # prefix DP over contiguous topological groups; fewer groups
    # preferred on ties (the j == 0 single-group candidate is tried
    # first and later candidates must be strictly cheaper)
    memo: Dict = {}
    if priced_whole:
        (b, d), (words, vmem, _, s_cal, _) = priced_whole[0]
        memo[(0, n_stages)] = (words, s_cal, vmem, b, d)
    else:
        memo[(0, n_stages)] = None
    state: List = [None] * (n_stages + 1)
    # words, seconds, vmem, groups, blocks, depths
    state[0] = (0, 0.0, 0, (), (), ())
    for i in range(1, n_stages + 1):
        for j in range(0, i):
            if state[j] is None:
                continue
            g = best_group(j, i, memo)
            if g is None:
                continue
            cand = (state[j][0] + g[0], state[j][1] + g[1],
                    max(state[j][2], g[2]),
                    state[j][3] + ((j, i),), state[j][4] + (g[3],),
                    state[j][5] + (g[4],))
            if state[i] is None or (cand[0], cand[1]) \
                    < (state[i][0], state[i][1]):
                state[i] = cand
    best = state[n_stages]
    if best is None:
        raise ValueError(
            "pipeline DSE: no tile candidate fits on-chip budget "
            f"{vmem_budget} B for '{pipe.name}' "
            f"({counters['explored']} candidates over {cands})")

    return PipelinePlan(
        block=int(best[4][0]), groups=best[3], group_blocks=best[4],
        traffic_words=int(best[0]),
        unfused_traffic_words=plmod.unfused_traffic_words(pipe),
        vmem_bytes=int(best[2]), modeled_seconds=float(best[1]),
        explored=counters["explored"], pruned=counters["pruned"],
        depths=best[5])
