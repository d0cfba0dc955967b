"""Tile-size design-space exploration (paper §4): single patterns and
joint tile/fusion search for pipelines.

    "In future work, tile sizes for all pattern dimensions will instead
     be determined by the compiler through automated tile size selection
     using modeling and design space exploration."  (paper, §4)

This is the analytic part of the JAX reference's ``dse``:

* ``explore`` (one untiled pattern) enumerates lane/sublane-aligned
  divisor tiles for every named pattern domain (``tile_space``),
  crossed with the metapipeline buffer depths, tiles each candidate
  with ``strip_mine.tile`` and prices it (``price``): main-memory reads
  over the tier's bandwidth, scaled by the metapipeline schedule's
  overlap, with ``depth x`` on-chip bytes charged per stage buffer.
  The argmin is a ``TilePlan``: fewest words, then modeled seconds,
  then the shallowest depth, then the largest footprint.
* ``explore_pipeline`` (a pipeline DAG) does the same for the shared
  streaming tile of the fused megakernel and, when nothing fused fits,
  splits the DAG at its cheapest contiguous topological cuts by a
  prefix DP.

Both prune what busts the on-chip budget (the paper's BRAM-capacity
compile check; on the GPU the shared memory one block may use).
Pricing is uncalibrated: datasheet bandwidth.  Handed ``cost.TPU`` the
DSE reproduces the reference's plans exactly; by default it plans for
the card a run is on (``cost.device_tier``).  The tuning runtime around
the reference's DSE (the tuning cache, measured ``top_k`` mode, shape
buckets, quarantine and certification) is not part of this port yet;
asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
import operator
from typing import Dict, List, Optional, Tuple

import torch

from . import ir
from . import pipeline as plmod
from .cost import Tier, device_tier, stream_seconds, traffic
from .memory import plan_memory
from .scheduling import build_schedule, model_speedup
from .strip_mine import insert_tile_copies, strip_mine, tile

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

# the tuning runtime's keys of the reference's plan JSON, at the values
# of an analytic plan: written so the reference reads a port plan as its
# own, ignored when a plan is read
_TUNING_JSON = {"measured": False, "measured_seconds": 0.0, "timed": 0,
                "key": ""}

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


def tier_of(tier: Optional[Tier], device) -> Tier:
    """``tier``, else the tier of ``device`` (the card unless the caller
    names another device; raises without one)."""
    if tier is not None:
        return tier
    from ..device import resolve
    return device_tier(resolve(device))


def _uncalibrated(seconds: float, tier: Tier) -> float:
    """The reference prices the stream's bytes (seconds x bandwidth)
    over datasheet bandwidth again.  The round trip is not the identity
    in floating point, and keeping it makes the modeled seconds agree
    bitwise; a measured profile takes its place with the tuning-runtime
    slice."""
    stream_bytes = seconds * tier.hbm_bytes_per_s
    return stream_bytes / tier.hbm_bytes_per_s


# --------------------------------------------------------------------
# Single patterns
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """DSE result for one pattern: per-pattern tile sizes plus the
    model's accounting.

    ``depths`` maps each tiled pattern name to the metapipeline buffer
    depth the search selected (one searched depth per plan, recorded per
    pattern like ``sizes``); ``depth`` is the scalar view.  The JSON form
    is the reference's, so a plan carries across the two packages.
    """

    sizes: Dict[str, Tuple[int, ...]]
    traffic_words: int
    vmem_bytes: int
    modeled_seconds: float
    explored: int = 0        # candidates priced
    pruned: int = 0          # candidates rejected by the on-chip budget
    thinned: bool = False    # search space was capped (MAX_POINTS)
    depths: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def depth(self) -> int:
        """The plan's stage-buffer depth (2 when unrecorded)."""
        return next(iter(self.depths.values()), 2)

    def to_json(self) -> Dict:
        return {
            "sizes": {k: list(v) for k, v in self.sizes.items()},
            "depths": {k: int(v) for k, v in self.depths.items()},
            "traffic_words": int(self.traffic_words),
            "vmem_bytes": int(self.vmem_bytes),
            "modeled_seconds": float(self.modeled_seconds),
            "explored": int(self.explored),
            "pruned": int(self.pruned),
            "thinned": bool(self.thinned),
            **_TUNING_JSON,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "TilePlan":
        return cls(sizes={k: tuple(v) for k, v in d["sizes"].items()},
                   depths={k: int(v)
                           for k, v in d.get("depths", {}).items()},
                   traffic_words=int(d["traffic_words"]),
                   vmem_bytes=int(d["vmem_bytes"]),
                   modeled_seconds=float(d["modeled_seconds"]),
                   explored=int(d.get("explored", 0)),
                   pruned=int(d.get("pruned", 0)),
                   thinned=bool(d.get("thinned", False)))


def tile_space(p: ir.Pattern) -> Dict[str, List[Tuple[int, ...]]]:
    """Per-named-pattern candidate tile tuples for every untiled domain
    (the design space is their cross product).  Patterns that already
    carry a strided domain are left alone; rows are aligned to the
    pattern dtype's sublane multiple."""
    space: Dict[str, List[Tuple[int, ...]]] = {}
    for q in ir.walk(p):
        if q.strided or not q.domain or q.name in space:
            continue
        sub = dtype_sublane(q.dtype)
        per_dim = [axis_candidates(d, MXU, sublane=sub) for d in q.domain]
        space[q.name] = [tuple(c) for c in itertools.product(*per_dim)]
    return space


def _thin(space: Dict[str, List[Tuple[int, ...]]],
          max_points: int) -> Tuple[Dict[str, List[Tuple[int, ...]]], bool]:
    """Halve the densest axis list (keeping endpoints) until the cross
    product is within budget.  Returns (space, was_thinned)."""
    def total(s):
        t = 1
        for v in s.values():
            t *= len(v)
        return t

    thinned = False
    space = {k: list(v) for k, v in space.items()}
    while total(space) > max_points:
        name = max(space, key=lambda k: len(space[k]))
        v = space[name]
        if len(v) <= 2:
            break
        space[name] = v[::2] if v[-1] == v[::2][-1] else v[::2] + [v[-1]]
        thinned = True
    return space, thinned


def grid_steps(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]]) -> int:
    """Grid steps the tiled program executes: the product of extent /
    tile over every tiled domain (the trip count a measured profile will
    charge per-step overhead against)."""
    steps = 1
    for q in ir.walk(p):
        if q.name not in sizes or not q.domain:
            continue
        for d, s in zip(q.domain, sizes[q.name]):
            steps *= max(1, -(-d // max(int(s), 1)))
    return steps


# what tile() raises when interchange or stage lifting does not apply
_TILE_ERRORS = (ValueError, TypeError, KeyError, IndexError,
                NotImplementedError, ArithmeticError, RuntimeError)


def _tile_ir(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]],
             vmem_budget_words: int) -> ir.Pattern:
    """``tile(p, sizes)``, or strip mining plus tile copies alone where
    interchange or stage lifting does not apply (as the reference)."""
    try:
        return tile(p, sizes, vmem_budget_words=vmem_budget_words)
    except _TILE_ERRORS:
        return insert_tile_copies(strip_mine(p, sizes),
                                  vmem_budget_words=vmem_budget_words)


@dataclasses.dataclass(frozen=True)
class Priced:
    sizes: Dict[str, Tuple[int, ...]]
    traffic_words: int
    vmem_bytes: int
    seconds: float              # through the pricing seam (_uncalibrated)
    depth: int


def price(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]], *, tier: Tier,
          vmem_budget: int, depth: int = 2) -> Optional[Priced]:
    """Tile ``p`` with ``sizes`` and price it at stage-buffer ``depth``;
    None if it busts the on-chip budget.

    Modeled seconds = the tiled IR's main-memory reads over the tier's
    bandwidth, scaled by the metapipeline time ratio of its schedule
    (steady state vs. sequential, with whatever load issue latency
    ``depth - 1`` steps of lookahead cannot hide)."""
    t = _tile_ir(p, sizes, vmem_budget // 4)
    plan = plan_memory(t, vmem_budget_bytes=vmem_budget, depth=depth)
    if not plan.fits:
        return None
    # an affine tensor read left in place means its tile copy would not
    # fit on chip (insert_tile_copies' streaming fallback): over budget
    for q in ir.walk(t):
        for a in q.accesses:
            if isinstance(a.src, ir.Tensor) and a.affine:
                return None
    tr = traffic(t)
    seconds = stream_seconds(tr.total_reads, tier=tier)
    mp = build_schedule(t, vmem_budget // 4, depth=depth)
    if mp is not None:
        body_words = sum(s.words for s in mp.stages if s.kind == "body")
        seq, pipe, _ = model_speedup(mp, flops_per_body=body_words * 100.0,
                                     tier=tier)
        if seq > 0 and pipe > 0:
            seconds *= pipe / seq
    return Priced(dict(sizes), tr.total_reads, plan.total_bytes,
                  _uncalibrated(seconds, tier), depth)


def _rank_key(a: Priced) -> Tuple:
    # depth breaks seconds ties BEFORE the -vmem reuse term: once the
    # exposed-latency term saturates, deeper variants tie on seconds
    # and their larger footprint must not win via the reuse preference
    return (a.traffic_words, a.seconds, a.depth, -a.vmem_bytes)


def shortlist(p: ir.Pattern, *, tier: Tier, vmem_budget: int
              ) -> Tuple[List[Priced], bool, int, int]:
    """Every feasible (tile sizes, depth) candidate, priced and sorted
    best-first.  Returns ``(candidates, thinned, explored, pruned)``."""
    space, thinned = _thin(tile_space(p), MAX_POINTS)
    names = sorted(space)
    cands: List[Priced] = []
    explored = pruned = 0
    for combo in itertools.product(*(space[n] for n in names)):
        sizes = dict(zip(names, combo))
        for d in DEPTHS:
            priced = price(p, sizes, tier=tier, vmem_budget=vmem_budget,
                           depth=d)
            explored += 1
            if priced is None:
                pruned += 1
                continue
            cands.append(priced)
    cands.sort(key=_rank_key)
    return cands, thinned, explored, pruned


def explore(p: ir.Pattern, *, tier: Optional[Tier] = None,
            vmem_budget: Optional[int] = None, device=None,
            **tuning) -> TilePlan:
    """Design-space exploration over tile sizes and metapipeline buffer
    depths for one *untiled* pattern program.

    Each (sizes, depth) candidate of ``tile_space`` x ``DEPTHS`` is
    priced with ``depth x`` on-chip bytes per stage buffer and the load
    latency the depth cannot hide; the lexicographic argmin (words,
    seconds, depth, -bytes) wins.  ``tier`` defaults to the tier of
    ``device`` (the card, CUDA unless said otherwise); ``vmem_budget``
    to the tier's on-chip bytes.  Raises ``ValueError`` when no
    candidate fits; the reference's tuning-runtime arguments raise
    ``NotImplementedError``.
    """
    _refuse_tuning_runtime(tuning)
    tier = tier_of(tier, device)
    vmem_budget = tier.onchip_bytes if vmem_budget is None else vmem_budget
    cands, thinned, explored, pruned = shortlist(p, tier=tier,
                                                 vmem_budget=vmem_budget)
    if not cands:
        raise ValueError(
            f"DSE: no tile candidate fits on-chip budget {vmem_budget} B "
            f"({explored} candidates over {sorted(tile_space(p))})")
    best = cands[0]
    return TilePlan(sizes={k: tuple(v) for k, v in best.sizes.items()},
                    depths={k: int(best.depth) for k in best.sizes},
                    traffic_words=best.traffic_words,
                    vmem_bytes=best.vmem_bytes,
                    modeled_seconds=best.seconds,
                    explored=explored, pruned=pruned, thinned=thinned)


def gemm_program(m: int, n: int, k: int) -> ir.Pattern:
    """The Table 3 GEMM of the benchmark suite, untiled."""
    from ..patterns.analytics import gemm
    return gemm(m, n, k)[0]


# --------------------------------------------------------------------
# Pipelines
# --------------------------------------------------------------------


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
    depths: Tuple[int, ...] = ()

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
            **_TUNING_JSON,
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
                   pruned=int(d.get("pruned", 0)))


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
    return (reads + out_w, mem.total_bytes, seconds,
            _uncalibrated(seconds, tier), int(fdag.grid))


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
    tier = tier_of(tier, device)
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


# --------------------------------------------------------------------
# Proxy programs of the hand-written kernels (analysed, never lowered:
# torch bodies for the oracle, no CUDA body)
# --------------------------------------------------------------------


def attention_program(sq: int, sk: int, d: int) -> ir.Pattern:
    """Flash attention as Map(queries){ MultiFold(keys) } -- the online-
    softmax fold over keys nested in the query map.

    Tileable domains: ``fa_q`` (query block) and ``fa_kv`` (kv block).
    """
    q = ir.Tensor("q", (sq, d))
    k = ir.Tensor("k", (sk, d))
    v = ir.Tensor("v", (sk, d))
    kv = ir.MultiFold(
        domain=(sk,), range_shape=(d,), init=lambda: torch.zeros((d,)),
        reads=(ir.Access(q, lambda i, kk: (i, 0), (1, d)),
               ir.Access(k, lambda i, kk: (kk, 0), (1, d)),
               ir.Access(v, lambda i, kk: (kk, 0), (1, d))),
        out_index_map=lambda i, kk: (0,), update_shape=(d,),
        fn=lambda s, acc, qe, ke, ve:
            acc + (qe * ke).sum(-1, keepdim=True) * ve,
        combine=operator.add, name="fa_kv")
    return ir.Map(domain=(sq,), elem_shape=(d,), inner=kv, name="fa_q")


def scan_program(seq: int, n: int, dh: int) -> ir.Pattern:
    """The SSD chunked scan's sequence fold: per step read an x row, a
    dt scalar and B/C rows, update the carried (n, dh) state.

    Tileable domain: ``ssd`` (the chunk length).
    """
    x = ir.Tensor("x", (seq, dh))
    dt = ir.Tensor("dt", (seq,))
    B = ir.Tensor("B", (seq, n))
    C = ir.Tensor("C", (seq, n))
    return ir.MultiFold(
        domain=(seq,), range_shape=(n, dh), init=lambda: torch.zeros((n, dh)),
        reads=(ir.Access(x, lambda i: (i, 0), (1, dh)),
               ir.elem(dt),
               ir.Access(B, lambda i: (i, 0), (1, n)),
               ir.Access(C, lambda i: (i, 0), (1, n))),
        out_index_map=lambda i: (0, 0), update_shape=(n, dh),
        fn=lambda s, acc, xe, dte, be, ce:
            acc + be[..., :, None] * xe[..., None, :] * dte[..., None, None],
        combine=operator.add, name="ssd")


def filter_reduce_program(t: int) -> ir.Pattern:
    """TPC-H Q6 shape: fused filter + weighted-sum fold over one stream
    (tileable domain: ``fr``)."""
    x = ir.Tensor("x", (t,))
    w = ir.Tensor("w", (t,))
    return ir.MultiFold(
        domain=(t,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(x), ir.elem(w)),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, xe, we: acc + xe * we,
        combine=operator.add, name="fr")


def groupby_program(t: int, num_keys: int, ew: int) -> ir.Pattern:
    """Keyed fold over a (t,) stream into a dense (num_keys, ew)
    accumulator (tileable domain: ``gbf``)."""
    keys = ir.Tensor("keys", (t,), "int32")
    vals = ir.Tensor("vals", (t, ew))
    return ir.GroupByFold(
        domain=(t,), num_keys=num_keys, elem_shape=(ew,),
        init=lambda: torch.zeros((num_keys, ew)),
        reads=(ir.elem(keys),
               ir.Access(vals, lambda i: (i, 0), (1, ew))),
        fn=lambda s, ke, ve: (ke.to(torch.int32), ve),
        combine=operator.add, name="gbf")


def filter_fold_pipeline(t: int):
    """TPC-H Q6 as a two-stage pipeline: a mask Map producing the
    per-record contribution, folded by a separate sum stage.  The fused
    kernel keeps the (t,) intermediate on chip; unfused, it round-trips
    main memory (the quantity ``PipelinePlan.traffic_ratio`` reports)."""
    x = ir.Tensor("x", (t,))
    w = ir.Tensor("w", (t,))
    mask = ir.Map(domain=(t,), reads=(ir.elem(x), ir.elem(w)),
                  fn=lambda s, xe, we: xe * we, name="ff_mask")
    total = ir.MultiFold(
        domain=(t,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(ir.Tensor("ff_mask", (t,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: acc + v,
        combine=operator.add, name="ff_sum")
    return plmod.Pipeline(name="filter_fold", stages=(mask, total))


# --------------------------------------------------------------------
# Block sizes of the hand-written kernels (one selector per kernel).
# Each takes ``tier`` / ``vmem_budget`` / ``device`` as ``explore`` does
# and returns ``(blocks, plan)``.
# --------------------------------------------------------------------


def _one(plan: TilePlan, name: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in plan.sizes[name])


def select_gemm_blocks(m: int, n: int, k: int, *, tier: Optional[Tier] = None,
                       vmem_budget: Optional[int] = None, device=None,
                       **tuning) -> Tuple[Tuple[int, int, int], TilePlan]:
    """``(block_m, block_n, block_k)`` for ``kernels.matmul``."""
    plan = explore(gemm_program(m, n, k), tier=tier, vmem_budget=vmem_budget,
                   device=device, **tuning)
    (bm, bn), (bk,) = _one(plan, "gemm"), _one(plan, "gemm_k")
    return (bm, bn, bk), plan


def select_attention_blocks(sq: int, sk: int, d: int, *,
                            tier: Optional[Tier] = None,
                            vmem_budget: Optional[int] = None, device=None,
                            **tuning) -> Tuple[Tuple[int, int], TilePlan]:
    """``(block_q, block_k)`` for ``kernels.flash_attention``."""
    plan = explore(attention_program(sq, sk, d), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bq,), (bk,) = _one(plan, "fa_q"), _one(plan, "fa_kv")
    return (bq, bk), plan


def select_scan_blocks(seq: int, n: int, dh: int, *,
                       tier: Optional[Tier] = None,
                       vmem_budget: Optional[int] = None, device=None,
                       **tuning) -> Tuple[int, TilePlan]:
    """``chunk`` for ``kernels.ssd_scan``."""
    plan = explore(scan_program(seq, n, dh), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (chunk,) = _one(plan, "ssd")
    return chunk, plan


def select_filter_reduce_blocks(t: int, *, tier: Optional[Tier] = None,
                                vmem_budget: Optional[int] = None,
                                device=None, **tuning
                                ) -> Tuple[int, TilePlan]:
    """``block_t`` for ``kernels.filter_reduce``."""
    plan = explore(filter_reduce_program(t), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bt,) = _one(plan, "fr")
    return bt, plan


def select_groupby_blocks(t: int, num_keys: int, ew: int, *,
                          tier: Optional[Tier] = None,
                          vmem_budget: Optional[int] = None, device=None,
                          **tuning) -> Tuple[int, TilePlan]:
    """``block_t`` for ``kernels.groupby_fold``."""
    plan = explore(groupby_program(t, num_keys, ew), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bt,) = _one(plan, "gbf")
    return bt, plan


def select_fused_filter_fold_blocks(t: int, *, tier: Optional[Tier] = None,
                                    vmem_budget: Optional[int] = None,
                                    device=None, **tuning
                                    ) -> Tuple[int, PipelinePlan]:
    """``block_t`` for ``kernels.fused_filter_fold``: one joint plan for
    the filter -> fold pipeline."""
    plan = explore_pipeline(filter_fold_pipeline(t), tier=tier,
                            vmem_budget=vmem_budget, device=device, **tuning)
    return plan.block, plan


def select_fused_kmeans_blocks(n: int, k: int, d: int, *,
                               tier: Optional[Tier] = None,
                               vmem_budget: Optional[int] = None,
                               device=None, **tuning
                               ) -> Tuple[int, PipelinePlan]:
    """``block_n`` for ``kernels.fused_kmeans``: one joint plan for the
    assign -> {scatter-sum, count} DAG."""
    from ..patterns.analytics import kmeans_pipeline
    pipe, _, _ = kmeans_pipeline(n, k, d)
    plan = explore_pipeline(pipe, tier=tier, vmem_budget=vmem_budget,
                            device=device, **tuning)
    return plan.block, plan



# --------------------------------------------------------------------
# Paged serving decode: layout x page_size x block as joint DSE axes
# --------------------------------------------------------------------

PAGED_LAYOUTS = ("split", "fused")   # split K/V pools vs head-interleaved
PAGE_SIZES = (8, 16, 32, 64)


def _append_fn(s, pagerow, new, ln):
    pagerow, new = pagerow.reshape(-1), new.reshape(-1)
    return torch.where(s[0] == ln.reshape(()), new, pagerow)


def paged_decode_pipeline(max_len: int, page_size: int, d: int,
                          layout: str = "split"):
    """One decode step as the ``decode_attention`` pipeline DAG: a
    KV-append producer Map (the step's token merged at the ``seq_len``
    slot) feeding a flash-attention MultiFold terminal, over a *ragged*
    streaming domain (``ir.RaggedExtent``: the static extent is the
    page-padded context bound, the live extent the run-time ``seq_len``,
    masked at page granularity).

    ``split`` streams separate K and V rows through two producer
    stages; ``fused`` one head-interleaved ``2d`` row through a single
    stage: the same words in half the streams, which the metapipeline
    model prices differently.  Analysed, never lowered (the kernel is
    ``codegen_cuda.lower_paged_decode``).
    """
    if layout not in PAGED_LAYOUTS:
        raise ValueError(f"layout {layout!r}; one of {PAGED_LAYOUTS}")
    padded = -(-max_len // page_size) * page_size
    rag = ir.RaggedExtent(max=padded, length_name="seq_len",
                          granularity=page_size)
    q = ir.Tensor("q", (1, d))
    seq_len = ir.Tensor("seq_len", (1,), "int32")
    scale = d ** -0.5

    def weight(s, krow, qv, ln):
        live = s[0] <= ln.reshape(())
        return torch.where(live, torch.exp((qv * krow).sum() * scale), 0.0)

    if layout == "fused":
        pages = ir.Tensor("kv_pages", (padded, 2 * d))
        new_kv = ir.Tensor("new_kv", (1, 2 * d))
        append = ir.Map(
            domain=(padded,), elem_shape=(2 * d,),
            reads=(ir.Access(pages, lambda i: (i, 0), (1, 2 * d)),
                   ir.whole(new_kv), ir.whole(seq_len)),
            fn=_append_fn, name="pd_append", ragged=rag)

        def fold_fn(s, acc, kvrow, qv, ln):
            kvrow, qv = kvrow.reshape(-1), qv.reshape(-1)
            return acc + weight(s, kvrow[:d], qv, ln) * kvrow[d:]

        fold = ir.MultiFold(
            domain=(padded,), range_shape=(d,),
            init=lambda: torch.zeros((d,)),
            reads=(ir.Access(ir.Tensor("pd_append", (padded, 2 * d)),
                             lambda i: (i, 0), (1, 2 * d)),
                   ir.whole(q), ir.whole(seq_len)),
            out_index_map=lambda i: (0,), update_shape=(d,),
            fn=fold_fn, combine=operator.add, name="pd_kv", ragged=rag)
        return plmod.Pipeline(name="paged_decode_fused",
                              stages=(append, fold))

    k_pages = ir.Tensor("k_pages", (padded, d))
    v_pages = ir.Tensor("v_pages", (padded, d))
    new_k = ir.Tensor("new_k", (1, d))
    new_v = ir.Tensor("new_v", (1, d))
    app_k = ir.Map(
        domain=(padded,), elem_shape=(d,),
        reads=(ir.Access(k_pages, lambda i: (i, 0), (1, d)),
               ir.whole(new_k), ir.whole(seq_len)),
        fn=_append_fn, name="pd_append_k", ragged=rag)
    app_v = ir.Map(
        domain=(padded,), elem_shape=(d,),
        reads=(ir.Access(v_pages, lambda i: (i, 0), (1, d)),
               ir.whole(new_v), ir.whole(seq_len)),
        fn=_append_fn, name="pd_append_v", ragged=rag)

    def fold_fn_split(s, acc, krow, vrow, qv, ln):
        krow, vrow, qv = krow.reshape(-1), vrow.reshape(-1), qv.reshape(-1)
        return acc + weight(s, krow, qv, ln) * vrow

    fold = ir.MultiFold(
        domain=(padded,), range_shape=(d,),
        init=lambda: torch.zeros((d,)),
        reads=(ir.Access(ir.Tensor("pd_append_k", (padded, d)),
                         lambda i: (i, 0), (1, d)),
               ir.Access(ir.Tensor("pd_append_v", (padded, d)),
                         lambda i: (i, 0), (1, d)),
               ir.whole(q), ir.whole(seq_len)),
        out_index_map=lambda i: (0,), update_shape=(d,),
        fn=fold_fn_split, combine=operator.add, name="pd_kv", ragged=rag)
    return plmod.Pipeline(name="paged_decode_split",
                          stages=(app_k, app_v, fold))


def select_paged_decode_blocks(
        max_len: int, d: int, *, tier: Optional[Tier] = None,
        vmem_budget: Optional[int] = None, device=None, **tuning
        ) -> Tuple[Tuple[str, int, int, int], TilePlan]:
    """``(layout, page_size, block, depth)`` for
    ``codegen_cuda.lower_paged_decode``: a joint search over KV layout x
    page size x streaming block x buffer depth.

    Every (layout, page_size) pair prices its own ``decode_attention``
    proxy DAG through ``explore_pipeline`` (block x depth inside); the
    argmin on modeled seconds wins.  ``plan`` is a summary ``TilePlan``
    recording the joint axes: ``sizes["pd_kv"]`` the streaming block,
    ``sizes["pd_page"]`` the page size, ``sizes["pd_layout"]`` the
    layout's ``PAGED_LAYOUTS`` index, ``depths["pd_kv"]`` the depth.
    Raises ``ValueError`` when no candidate of any pair fits the
    budget, as the reference does.
    """
    _refuse_tuning_runtime(tuning)
    tier = tier_of(tier, device)
    page_sizes = [p for p in PAGE_SIZES if p <= max(max_len, PAGE_SIZES[0])]
    best = None
    explored = pruned = 0
    for layout in PAGED_LAYOUTS:
        for ps in page_sizes:
            pipe = paged_decode_pipeline(max_len, ps, d, layout)
            plan = explore_pipeline(pipe, tier=tier, vmem_budget=vmem_budget)
            explored += plan.explored
            pruned += plan.pruned
            if best is None or (plan.modeled_seconds
                                < best[2].modeled_seconds):
                best = (layout, ps, plan)
    layout, ps, pplan = best
    summary = TilePlan(
        sizes={"pd_kv": (int(pplan.block),), "pd_page": (int(ps),),
               "pd_layout": (PAGED_LAYOUTS.index(layout),)},
        traffic_words=pplan.traffic_words, vmem_bytes=pplan.vmem_bytes,
        modeled_seconds=pplan.modeled_seconds, explored=explored,
        pruned=pruned, depths={"pd_kv": int(pplan.depth)})
    return (layout, int(ps), int(pplan.block), int(pplan.depth)), summary
