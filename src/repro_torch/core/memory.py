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


# ------------------------------------------------------------------
# Nearest-row stages (``ir.Map.nearest``): the table in tiles of rows
# ------------------------------------------------------------------
# A stage whose value is the nearest row of a K x D table (k-means'
# assignment) reads the whole table per row.  The fused lowering strip-
# mines that argmin fold over the table's rows: a block's BLOCK query
# rows meet the table TILE rows at a time, both streamed through a
# DEPTH-slot ring of slab-dimension slices, each thread holding a TM x TN
# block of partial distances in registers; a keyed sum of rows
# (``ir.GroupByFold.keyed_rows``) whose table is wider than a block's
# shared memory is folded a column slice of FOLD_COLS at a time by a
# second kernel over (row chunk x column slice) units
# (``kernels/csrc/nearest_dag.cuh`` sets the kernels out).

NEAREST_THREADS = 256    # ndag::THREADS
NEAREST_SLABS = (56, 32, 28, 16)   # dimensions of a ring slot, by rule
NEAREST_TN = 8           # table rows a thread holds, at most
NEAREST_TM = 8           # query rows a thread holds, at most
FOLD_ROWS = 64           # rows of a fold ring slot
FOLD_DEPTH_MAX = 4       # slots of the fold's ring, at most
FOLD_CHUNKS = 128        # row chunks of the fold: its partial tables
FOLD_COLS_MAX = 128      # columns of a fold unit: 4 warps


@dataclasses.dataclass(frozen=True)
class NearestLayout:
    """The shape of a nearest-row DAG's kernels at one plan."""

    block: int       # query rows of a grid step
    tile: int        # table rows of a tile
    tm: int          # query rows a thread holds
    tn: int          # table rows a thread holds
    depth: int       # ring slots (both kernels)
    keys: int        # table rows K
    dim: int         # row width D
    fold_cols: int   # columns of a fold unit; 0: no keyed sum of rows
    fold_depth: int  # the fold's ring slots: as many as fit
    slab: int        # dimensions of a ring slot

    @property
    def pad(self) -> int:
        """Words of padding per staged row: the row stride an odd number
        of 16-byte pieces, so the eight rows of an LDS.128 phase fall in
        distinct banks."""
        return 4 if (self.slab // 4) % 2 == 0 else 8

    @property
    def tiles(self) -> int:
        return -(-self.keys // self.tile)

    @property
    def slabs(self) -> int:
        return -(-self.dim // self.slab)

    @property
    def slices(self) -> int:
        return -(-self.dim // self.fold_cols) if self.fold_cols else 0

    @property
    def slot_words(self) -> int:
        return (self.block + self.tile) * (self.slab + self.pad)

    @property
    def assign_bytes(self) -> int:
        """The assignment kernel's charge: the ring, the table's row
        norms (padded to whole tiles) and the stage's keys."""
        return 4 * (self.depth * self.slot_words + self.tiles * self.tile
                    + self.block)

    @property
    def fold_bytes(self) -> int:
        """The fold kernel's: one unit's table slice and its ring of
        rows and keys (a streaming pass: its ring is as deep as fits, so
        that enough bytes are in flight to keep up with main memory)."""
        if not self.fold_cols:
            return 0
        return 4 * (self.keys * self.fold_cols
                    + self.fold_depth * FOLD_ROWS * (self.fold_cols + 1))


def nearest_layout(block: int, depth: int, keys: int, dim: int,
                   folded: bool, budget: int):
    """The layout of a nearest-row DAG at ``block`` rows and ``depth``
    slots, or None where the kernels cannot take it: tiles of as many
    table rows as make an 8 x 8 block of distances a thread
    (``16384 / block``), a thread's ``tm`` x ``tn`` with the tile's
    ``tile / tn`` lanes in one warp, and, for a keyed sum of rows, fold
    units of the widest multiple of 32 columns up to FOLD_COLS_MAX whose
    table slice leaves room for two ring slots in ``budget``, the fold's
    ring as deep as fits, up to FOLD_DEPTH_MAX.  The ring's slot holds
    the first of NEAREST_SLABS that divides ``dim`` (else the last, the
    tail zero-filled).  Raises nothing."""
    if dim % 4 or depth < 2 or block % 8:
        return None
    tile = NEAREST_THREADS * NEAREST_TM * NEAREST_TN // block
    tn = min(NEAREST_TN, tile)
    if tile < 1 or tile % tn:
        return None
    tx = tile // tn
    if tx > 32 or tx & (tx - 1) or NEAREST_THREADS % tx:
        return None
    ty = NEAREST_THREADS // tx
    if block % ty or not 1 <= block // ty <= NEAREST_TM:
        return None
    cols = fdepth = 0

    def slots(c):   # the fold's ring slots beside a table slice of c
        return min(FOLD_DEPTH_MAX, (budget // 4 - keys * c)
                   // (FOLD_ROWS * (c + 1)))
    if folded:
        cols = min(FOLD_COLS_MAX, -(-dim // 32) * 32)
        while cols > 32 and slots(cols) < 2:
            cols -= 32
        if slots(cols) < 2:
            return None
        fdepth = slots(cols)
    slab = next((s for s in NEAREST_SLABS if dim % s == 0),
                NEAREST_SLABS[-1])
    lay = NearestLayout(block, tile, block // ty, tn, depth, keys, dim, cols,
                        fdepth, slab)
    if lay.assign_bytes > budget or lay.fold_bytes > budget:
        return None
    return lay


def nearest_dag(patterns: Sequence[ir.Pattern]):
    """For the per-terminal trees of a fused DAG: ``(K, D, folded)`` of
    its nearest-row stage (the table's shape; whether a terminal is a
    keyed sum of rows), or None when no stage is a nearest-row one."""
    found = None
    folded = False
    for root in patterns:
        q = root.inner
        if isinstance(q, ir.GroupByFold) and q.keyed_rows is not None:
            folded = True
        for tc in root.loads:
            s = tc.src
            if isinstance(s, ir.Map) and s.nearest is not None:
                table = s.reads[s.nearest[0]].src
                if isinstance(table, ir.TileCopy):
                    table = table.src
                found = tuple(int(e) for e in table.shape)
    if found is None:
        return None
    return found + (folded,)
