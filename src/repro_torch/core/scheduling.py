"""Metapipeline scheduling (paper §5 "Metapipelining").

For every *strided* pattern in the tiled IR we build a metapipeline
schedule: a topological sort of the body into stages, where each stage
is a tile load, a lifted compute stage, the main inner pattern, or the
tile store.  Every buffer crossing a stage boundary is promoted to a
rotating buffer of configurable ``depth`` (WAR-hazard avoidance
between overlapped outer iterations; depth 2 -- the classic double
buffer -- is the minimum that lets producer and consumer stages
overlap, deeper buffers additionally hide DMA issue latency, see
``cost.metapipeline_time``); hoisted (loop-invariant) loads become a
preload step ("Pipe 0" of Fig. 6) outside the metapipeline.

The schedule also records the paper's two scheduling optimizations:
  * accumulator dedup -- a MultiFold tiled into a nested MultiFold
    keeps a single accumulator (the outer combine consumes the inner
    partial directly, no intermediate output buffer);
  * accumulator forwarding -- when the accumulator cannot fit on-chip
    the stages containing it get a forwarding path (we flag it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import ir
from .cost import (ONCHIP_WORDS, DEFAULT_TIER, StageCost, Tier,
                   metapipeline_time, stage_seconds_compute,
                   stage_seconds_load)


@dataclasses.dataclass
class Stage:
    name: str
    kind: str                     # preload | load | compute | body | store
    words: int                    # data moved or buffered
    double_buffered: bool = False
    deps: Tuple[str, ...] = ()
    depth: int = 1                # buffer copies (2 = double buffer)


@dataclasses.dataclass
class Metapipeline:
    pattern: str
    outer_trips: int
    stages: List[Stage]
    preloads: List[Stage]
    fused_accumulator: bool       # accumulator dedup applied
    accumulator_forwarding: bool  # acc does not fit on-chip
    children: List["Metapipeline"]
    depth: int = 2                # stage-crossing buffer depth

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}Metapipeline[{self.pattern}] x{self.outer_trips}"
                 + (f" depth={self.depth}" if self.depth != 2 else "")
                 + (" (acc-fused)" if self.fused_accumulator else "")
                 + (" (acc-forwarding)" if self.accumulator_forwarding
                    else "")]
        for s in self.preloads:
            lines.append(f"{pad}  Pipe0 preload {s.name} ({s.words} words)")
        for i, s in enumerate(self.stages):
            db = ""
            if s.double_buffered:
                db = " [dbl-buf]" if s.depth == 2 else f" [buf x{s.depth}]"
            lines.append(f"{pad}  Stage{i+1} {s.kind} {s.name}"
                         f" ({s.words} words){db}")
        for c in self.children:
            lines.append(c.describe(indent + 1))
        return "\n".join(lines)


def _acc_words(p: ir.MultiFold) -> int:
    return int(np.prod(p.range_shape)) if p.range_shape else 1


def build_schedule(p: ir.Pattern,
                   vmem_budget_words: int = ONCHIP_WORDS,
                   depth: int = 2) -> Optional[Metapipeline]:
    """Metapipeline schedule for the outermost strided pattern.

    Parameters
    ----------
    p : tiled (strided) pattern; ``None`` is returned for an untiled
        program (nothing to metapipeline).
    vmem_budget_words : on-chip capacity used for the accumulator-
        forwarding check (an accumulator larger than this gets a
        forwarding path instead of a resident buffer).
    depth : stage-crossing buffer depth.  Every non-hoisted stage
        buffer is annotated with this depth (2 = classic double
        buffer; deeper buffers hide more DMA issue latency at the cost
        of ``depth x`` on-chip bytes, see ``cost.metapipeline_time`` /
        ``memory.plan_memory``).  Hoisted preloads stay single-buffered
        (depth 1).  The DSE (``dse.explore`` / ``dse.explore_pipeline``)
        searches this knob jointly with tile sizes.
    """
    if depth < 2:
        raise ValueError(f"metapipeline depth must be >= 2, got {depth}")
    if not p.strided:
        # descend: the root may be a plain wrapper
        if p.inner is not None:
            return build_schedule(p.inner, vmem_budget_words, depth)
        return None

    preloads: List[Stage] = []
    stages: List[Stage] = []
    children: List[Metapipeline] = []

    # topological order: tensor loads first (no deps), then lifted compute
    # stages (depend on loads), then the body, then the store.
    tensor_loads = [tc for tc in p.loads if isinstance(tc.src, ir.Tensor)]
    stage_loads = [tc for tc in p.loads if isinstance(tc.src, ir.Pattern)]

    for tc in tensor_loads:
        st = Stage(name=tc.name, kind="preload" if tc.hoisted else "load",
                   words=tc.words, double_buffered=not tc.hoisted,
                   depth=1 if tc.hoisted else depth)
        (preloads if tc.hoisted else stages).append(st)

    load_names = tuple(s.name for s in stages if s.kind == "load")
    for tc in stage_loads:
        stages.append(Stage(name=tc.name, kind="compute", words=tc.words,
                            double_buffered=True, deps=load_names,
                            depth=depth))
        sub = build_schedule(tc.src, vmem_budget_words, depth)
        if sub is not None:
            children.append(sub)

    fused_acc = False
    fwd = False
    if p.inner is not None:
        body_words = 0
        if isinstance(p, ir.MultiFold):
            body_words = int(np.prod(p.update_shape)) if p.update_shape else 1
            # accumulator dedup: tiled MultiFold-of-MultiFold emits one
            # accumulator; the outer combine reads the inner partial
            # directly (executor semantics), no intermediate buffer.
            fused_acc = (isinstance(p.inner, ir.MultiFold)
                         and p.combine is not None)
            fwd = _acc_words(p) > vmem_budget_words
        stages.append(Stage(
            name=p.inner.name, kind="body", words=body_words,
            double_buffered=True,
            deps=tuple(s.name for s in stages), depth=depth))
        sub = build_schedule(p.inner, vmem_budget_words, depth)
        if sub is not None:
            children.append(sub)

    out_words = int(np.prod(getattr(p, "range_shape", ()) or ())) or 1
    if isinstance(p, ir.MultiFold) and p.combine is None:
        # write-once tiled Map: stores one output tile per iteration
        stages.append(Stage(name="tile_store", kind="store",
                            words=int(np.prod(p.update_shape)),
                            deps=(stages[-1].name,)))
    elif isinstance(p, (ir.GroupByFold, ir.FlatMap)):
        stages.append(Stage(name="out_store", kind="store", words=out_words,
                            deps=(stages[-1].name,)))

    return Metapipeline(
        pattern=f"{type(p).__name__}:{p.name}", outer_trips=p.trip_count,
        stages=stages, preloads=preloads, fused_accumulator=fused_acc,
        accumulator_forwarding=fwd, children=children, depth=depth)


def model_speedup(mp: Metapipeline, flops_per_body: float,
                  bytes_per_word: int = 4, tier: Tier = DEFAULT_TIER
                  ) -> Tuple[float, float, float]:
    """(sequential_s, pipelined_s, speedup) under the two-resource model:
    load/store stages stream at the tier's main-memory bandwidth, body
    at its peak compute.
    The schedule's buffer ``depth`` feeds the exposed-DMA-latency term
    of ``cost.metapipeline_time``, so the ratio can drop below 1 when
    latency dominates a shallow pipeline (the DSE prices that)."""
    costs = []
    for s in mp.stages:
        if s.kind in ("load", "store"):
            costs.append(StageCost(s.name, s.kind,
                                   stage_seconds_load(s.words,
                                                      bytes_per_word, tier)))
        else:
            costs.append(StageCost(s.name, s.kind,
                                   stage_seconds_compute(flops_per_body,
                                                         tier)))
    seq, pipe = metapipeline_time(costs, mp.outer_trips, depth=mp.depth,
                                  dma_latency_s=tier.dma_latency_s)
    return seq, pipe, seq / pipe if pipe > 0 else 1.0
