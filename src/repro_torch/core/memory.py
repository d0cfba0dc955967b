"""Memory allocation analysis (paper §5 "Memory Allocation").

Walks the tiled IR and assigns every memory region to a hardware
structure, mirroring Table 4 of the paper with GPU targets:

  statically-sized array (tile copy)    -> Buffer (shared-memory tile)
  buffer crossing metapipeline stages   -> ``depth``-slot rotating buffer
  non-affine access on a dynamic array  -> Cache (a gather, no tag memory)
  FlatMap output                        -> Parallel FIFO (mask +
                                           compaction buffer)
  GroupByFold accumulator               -> CAM (a dense per-block table,
                                           num_keys bound)

The pass also checks the total against the on-chip budget -- on the
FPGA this is BRAM capacity, on the GPU the shared memory one block may
use; exceeding it is a compile-time error in both worlds.  The fused
megakernel (``codegen_cuda``) allocates exactly the bytes this plan
charges.

``plan_memory`` accepts either one tiled pattern or a *sequence* of
patterns that lower into one kernel (the per-terminal trees of a fused
pipeline DAG).  Buffers shared between trees -- a fan-out producer's
stage scratch (same TileCopy uid) or the same external tensor tile
(same ``fusion.tile_copy_key``) -- are allocated and charged exactly
once, with their port count reflecting every reader across the whole
terminal set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

import numpy as np

from . import ir
from .cost import DEFAULT_TIER


@dataclasses.dataclass
class BufferAlloc:
    name: str
    kind: str          # buffer | double_buffer | cache | fifo | cam_dense
    words: int
    dtype: str
    double_buffered: bool
    ports: int         # readers + writers (template parameterization)
    depth: int = 1     # buffer copies charged (2 = double buffer)


@dataclasses.dataclass
class MemoryPlan:
    buffers: List[BufferAlloc]
    vmem_budget_bytes: int

    @property
    def total_bytes(self) -> int:
        return sum(b.words * np.dtype(b.dtype).itemsize * max(b.depth, 1)
                   for b in self.buffers)

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.vmem_budget_bytes

    def describe(self) -> str:
        lines = [f"{'name':24s} {'kind':14s} {'words':>10s} "
                 f"{'depth':>5s} {'ports':>5s}"]
        for b in self.buffers:
            lines.append(f"{b.name:24s} {b.kind:14s} {b.words:>10d} "
                         f"{b.depth:>5d} {b.ports:>5d}")
        lines.append(f"total {self.total_bytes} B / budget "
                     f"{self.vmem_budget_bytes} B -> "
                     f"{'OK' if self.fits else 'OVERFLOW'}")
        return "\n".join(lines)


def plan_memory(p: Union[ir.Pattern, Sequence[ir.Pattern]],
                vmem_budget_bytes: int = DEFAULT_TIER.onchip_bytes,
                depth: int = 2) -> MemoryPlan:
    """On-chip allocation plan for one tiled pattern (or the per-terminal
    trees of a fused pipeline DAG, allocated jointly).

    Parameters
    ----------
    p : tiled pattern, or a sequence of patterns lowering into one
        kernel (buffers shared across trees are charged once).
    vmem_budget_bytes : on-chip capacity the plan is checked against
        (``MemoryPlan.fits``); on the FPGA this is BRAM capacity.
    depth : metapipeline buffer depth charged for every stage-crossing
        buffer (a strided pattern's non-hoisted loads).  Depth 2 is the
        classic double buffer; deeper buffering multiplies the charged
        bytes, so under a fixed budget it competes directly with bigger
        tiles -- the trade ``dse.explore`` searches.  Hoisted preloads,
        caches, FIFOs and CAM accumulators stay single-buffered.
    """
    from . import telemetry
    from .fusion import tile_copy_key  # local import: avoid cycle

    if depth < 2:
        raise ValueError(f"metapipeline depth must be >= 2, got {depth}")

    roots = tuple(p) if isinstance(p, (list, tuple)) else (p,)
    with telemetry.span("memory.plan", roots=len(roots),
                        depth=depth) as sp:
        plan = _plan_memory_body(roots, vmem_budget_bytes, depth,
                                 tile_copy_key)
        sp.set(total_bytes=plan.total_bytes, fits=plan.fits,
               buffers=len(plan.buffers))
    return plan


def _plan_memory_body(roots, vmem_budget_bytes: int, depth: int,
                      tile_copy_key) -> MemoryPlan:
    buffers: List[BufferAlloc] = []
    readers: Dict = {}

    # count readers of each tile copy (port analysis); fan-out readers
    # in other terminal trees accumulate onto the same shared buffer
    for root in roots:
        for q in ir.walk(root):
            for a in q.accesses:
                if isinstance(a.src, ir.TileCopy):
                    k = tile_copy_key(a.src)
                    readers[k] = readers.get(k, 0) + 1

    seen = set()
    idx = [0]

    def visit(q: ir.Pattern):
        for tc in q.loads:
            k = tile_copy_key(tc)
            if k in seen:
                continue
            seen.add(k)
            # a strided pattern's loads are its metapipeline stages:
            # every buffer crossing a stage boundary rotates ``depth``
            # copies (WAR avoidance between overlapped outer
            # iterations; depth 2 = the classic double buffer);
            # hoisted preloads are loop-invariant, so a single copy.
            dbl = q.strided and not tc.hoisted
            kind = "double_buffer" if dbl else "buffer"
            buffers.append(BufferAlloc(
                name=f"{tc.name}#{idx[0]}", kind=kind, words=tc.words,
                dtype=tc.dtype, double_buffered=dbl,
                ports=readers.get(k, 1) + 1,
                depth=depth if dbl else 1))
            idx[0] += 1
            if isinstance(tc.src, ir.Pattern):
                visit(tc.src)
        for a in q.accesses:
            if isinstance(a.src, ir.Tensor) and not a.affine:
                buffers.append(BufferAlloc(
                    name=f"{a.src.name}_cache#{idx[0]}", kind="cache",
                    words=a.words, dtype=a.src.dtype,
                    double_buffered=False, ports=2))
                idx[0] += 1
            elif isinstance(a.src, ir.Pattern):
                visit(a.src)
        if isinstance(q, ir.GroupByFold) and not q.strided:
            buffers.append(BufferAlloc(
                name=f"{q.name}_acc#{idx[0]}", kind="cam_dense",
                words=int(np.prod(q.shape)), dtype=q.dtype,
                double_buffered=False, ports=2))
            idx[0] += 1
        if isinstance(q, ir.FlatMap) and not q.strided:
            buffers.append(BufferAlloc(
                name=f"{q.name}_fifo#{idx[0]}", kind="fifo",
                words=int(np.prod(q.shape)), dtype=q.dtype,
                double_buffered=False, ports=2))
            idx[0] += 1
        if q.inner is not None:
            visit(q.inner)

    for root in roots:
        visit(root)
    return MemoryPlan(buffers, vmem_budget_bytes)
