"""Tile-level fusion: lift per-element pattern sources to per-tile stages.

The paper assumes aggressive vertical fusion has run *before* tiling
(Fig. 4 is the fused k-means).  After strip mining, a fused body that
computes a per-element intermediate (e.g. the closest-centroid pair for
one point) sits inside the tile loop as a per-element pattern source.
Splitting it out per the paper's heuristic creates a per-*tile* stage --
the `minDistWithInds` stage of Fig. 5b -- which (a) enables pattern
interchange and (b) becomes a metapipeline stage with its own double
buffer.

``lift_tile_stages`` performs that split: for an unstrided pattern Q
(the tile loop) directly inside a strided outer O, any access whose
source is a per-element pattern S is rewritten to read row ``l`` of a
new stage ``S_tile = Map(Q.domain){ S }`` attached to O as a
pattern-valued TileCopy.  The split is applied only when the
intermediate (``Q.domain + S.shape``) fits on-chip (``should_split``).

``fuse_dag_stages`` extends the same lifting *across pattern
boundaries*: a DAG of whole patterns sharing one streaming domain
(producer Maps feeding terminal folds / keyed folds / write-once Maps
through named intermediate tensors) fuses into one tiled pattern per
terminal, all sharing a single strided outer shape.  Each producer
becomes a per-tile stage (pattern-valued TileCopy) created *exactly
once* -- a fan-out intermediate consumed by several stages or terminals
is represented by one TileCopy whose stable ``uid`` every consumer
references, so downstream passes (memory planning, codegen) see one
on-chip scratch buffer and one set of main-memory feeds however many
readers it has.  Every read of an intermediate tensor is rewritten to read the
staged tile in place -- so intermediates never touch main memory (the
paper's vertical fusion, Fig. 4/5b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from . import ir
from .affine import AffineMap
from .cost import ONCHIP_WORDS
from .interchange import should_split


def _lift_in(outer: ir.Pattern, enc: int, budget: int) -> ir.Pattern:
    """outer = strided pattern; examine its direct inner (the tile loop)."""
    q = outer.inner
    if q is None or q.strided:
        return outer
    kq = len(q.domain)
    new_reads = []
    new_stages = []
    memo: Dict[int, ir.TileCopy] = {}
    changed = False
    for a in q.accesses:
        s = a.src
        if not isinstance(s, ir.Pattern):
            new_reads.append(a)
            continue
        inter_shape = tuple(q.domain) + tuple(s.shape)
        if not should_split(int(np.prod(inter_shape)), budget):
            new_reads.append(a)  # paper heuristic: keep fused
            continue
        if id(s) in memo:
            tc = memo[id(s)]
        else:
            # S's callables were written against (enc_outer, q_local, own);
            # inside Map(Q.domain) at outer level the stack is identical.
            stage = ir.Map(domain=tuple(q.domain), elem_shape=tuple(s.shape),
                           inner=s, name=s.name + "_stage", dtype=s.dtype)
            n_out = len(stage.shape)
            tc = ir.TileCopy(
                src=stage,
                index_map=AffineMap((0,) * n_out,
                                    tuple((0,) * enc for _ in range(n_out)),
                                    arity=enc),
                tile_shape=stage.shape, name=s.name + "_stage")
            memo[id(s)] = tc
            new_stages.append(tc)
        # Q's access now reads its local row of the staged tile
        n_out = len(tc.tile_shape)
        stack_len = enc + kq
        mat = []
        for d_out in range(n_out):
            row = [0] * stack_len
            if d_out < kq:  # leading dims index the tile row by q-local idx
                row[enc + d_out] = 1
            mat.append(tuple(row))
        window = (1,) * kq + tuple(s.shape)
        new_reads.append(dataclasses.replace(
            a, src=tc,
            index_map=AffineMap((0,) * n_out, tuple(mat), arity=stack_len),
            window=window))
        changed = True
    if not changed:
        return outer
    q2 = dataclasses.replace(q, reads=tuple(new_reads))
    return dataclasses.replace(
        outer, inner=q2, tile_loads=tuple(outer.loads) + tuple(new_stages))


def lift_tile_stages(p: ir.Pattern, *, enc: int = 0,
                     vmem_budget_words: int = ONCHIP_WORDS) -> ir.Pattern:
    """Apply the stage-lifting split everywhere it matches (post-order)."""

    def visit(node: ir.Pattern, enc_: int) -> ir.Pattern:
        updates = {}
        if node.inner is not None:
            updates["inner"] = visit(node.inner, enc_ + len(node.domain))
        rr, ch = [], False
        for a in node.accesses:
            if isinstance(a.src, ir.Pattern):
                ns = visit(a.src, enc_ + len(node.domain))
                if ns is not a.src:
                    rr.append(dataclasses.replace(a, src=ns))
                    ch = True
                    continue
            rr.append(a)
        if ch:
            updates["reads"] = tuple(rr)
        if updates:
            node = dataclasses.replace(node, **updates)
        if node.strided:
            node = _lift_in(node, enc_ + len(node.domain), vmem_budget_words)
        return node

    return visit(p, enc)


# --------------------------------------------------------------------------
# Cross-pattern lifting: fuse a pipeline of whole patterns into one
# tiled pattern (the stage-lifting split applied across pattern
# boundaries instead of within one body).
# --------------------------------------------------------------------------


def _rewire_intermediates(tile_pat: ir.Pattern, orig: ir.Pattern,
                          stage_tcs: Dict[str, ir.TileCopy]) -> ir.Pattern:
    """Redirect ``tile_pat``'s reads of intermediate tensors to the
    staged tiles.

    ``tile_pat`` is the strip-mined tile loop of ``orig`` (reads written
    against the (grid, local) stack); any read whose *original* source
    is a Tensor named like a staged producer becomes a read of row ``l``
    of that producer's TileCopy.  Only plain row accesses along the
    shared streaming domain are fusable -- anything else (shuffles,
    gathers across the boundary) must stay an HBM round-trip.
    """
    new_reads, changed = [], False
    for a_t, a_o in zip(tile_pat.reads, orig.reads):
        src = a_o.src
        if not (isinstance(src, ir.Tensor) and src.name in stage_tcs):
            new_reads.append(a_t)
            continue
        amap = AffineMap.probe(a_o.index_map, len(orig.domain))
        row_col = (1,) + (0,) * (amap.n_out - 1)
        if amap.base != (0,) * amap.n_out or amap.col(0) != row_col:
            raise NotImplementedError(
                f"pipeline fusion: read of intermediate '{src.name}' is "
                "not a row access along the shared domain "
                f"(base={amap.base}, col={amap.col(0)})")
        tc = stage_tcs[src.name]
        # at tile level the stack is (g, l); the staged tile holds the
        # current grid step's rows, so dim 0 indexes by the local l only
        mat = tuple((0, 1) if d == 0 else (0, 0)
                    for d in range(amap.n_out))
        new_reads.append(dataclasses.replace(
            a_t, src=tc,
            index_map=AffineMap((0,) * amap.n_out, mat, arity=2),
            window=a_o.window))
        changed = True
    if not changed:
        return tile_pat
    return dataclasses.replace(tile_pat, reads=tuple(new_reads))


def _stage_deps(stage: ir.Pattern, names: set) -> Tuple[str, ...]:
    """Names of the intermediates ``stage`` reads directly."""
    return tuple(a.src.name for a in stage.accesses
                 if isinstance(a.src, ir.Tensor) and a.src.name in names)


def fuse_dag_stages(stages: Sequence[ir.Pattern],
                    terminal_names: Sequence[str],
                    block: int) -> Dict[str, ir.Pattern]:
    """Fuse a DAG of untiled patterns over one shared 1-D domain.

    ``stages`` are in topological order; stages whose names are not in
    ``terminal_names`` are producer ``Map``s whose outputs later stages
    consume as Tensors named after the producing stage.  Returns one
    strip-mined pattern per terminal, each carrying the producer stages
    it (transitively) needs as per-tile pattern-valued TileCopies with
    intermediate reads rewired in place.  A producer consumed by
    several stages (fan-out) is lifted exactly once: all its consumers
    -- across terminals too -- reference the *same* TileCopy (same
    ``uid``), which is what keeps its on-chip scratch and main-memory feeds from
    being duplicated downstream.  Run ``strip_mine.insert_tile_copies``
    on each terminal afterwards to materialize the external tensor
    tiles.
    """
    from . import telemetry

    with telemetry.span("fusion.fuse_dag", stages=len(stages),
                        terminals=len(terminal_names),
                        block=int(block)):
        return _fuse_dag_body(stages, terminal_names, block)


def _fuse_dag_body(stages: Sequence[ir.Pattern],
                   terminal_names: Sequence[str],
                   block: int) -> Dict[str, ir.Pattern]:
    from .strip_mine import strip_mine  # local import: avoid cycle

    names = {s.name for s in stages}
    term_set = set(terminal_names)
    producers = [s for s in stages if s.name not in term_set]
    terminals = [s for s in stages if s.name in term_set]
    if any(len(s.domain) != 1 for s in stages):
        raise NotImplementedError("pipeline fusion: 1-D shared domain only")
    (n,) = terminals[-1].domain
    if any(s.domain != (n,) for s in stages):
        raise ValueError(
            f"pipeline stages must share the streaming domain ({n},): "
            f"{[s.domain for s in stages]}")
    if n % block != 0:
        raise ValueError(f"tile {block} must divide shared extent {n}")
    for s in producers:
        if not isinstance(s, ir.Map):
            raise NotImplementedError(
                f"pipeline producers must be Maps, got {type(s).__name__}")

    stage_tcs: Dict[str, ir.TileCopy] = {}
    deps: Dict[str, Tuple[str, ...]] = {}
    for s in producers:
        deps[s.name] = _stage_deps(s, names)
        stage_inner = strip_mine(s, {s.name: (block,)}).inner
        stage_inner = _rewire_intermediates(stage_inner, s, stage_tcs)
        n_out = 1 + len(s.elem_shape)
        tc = ir.TileCopy(
            src=stage_inner,
            index_map=AffineMap((0,) * n_out,
                                tuple((0,) for _ in range(n_out)),
                                arity=1),
            tile_shape=(block,) + tuple(s.elem_shape),
            name=s.name + "_stage")
        stage_tcs[s.name] = tc

    def closure(seed: Tuple[str, ...]) -> Tuple[str, ...]:
        """Transitive producer deps of ``seed``, in stage-lift order."""
        need = set()
        frontier = list(seed)
        while frontier:
            nm = frontier.pop()
            if nm in need or nm not in stage_tcs:
                continue
            need.add(nm)
            frontier.extend(deps.get(nm, ()))
        return tuple(nm for nm in stage_tcs if nm in need)

    out: Dict[str, ir.Pattern] = {}
    for t in terminals:
        outer = strip_mine(t, {t.name: (block,)})
        q2 = _rewire_intermediates(outer.inner, t, stage_tcs)
        needed = closure(_stage_deps(t, names))
        out[t.name] = dataclasses.replace(
            outer, inner=q2,
            tile_loads=tuple(outer.loads)
            + tuple(stage_tcs[nm] for nm in needed))
    return out


def fuse_pipeline_stages(stages: Sequence[ir.Pattern],
                         block: int) -> ir.Pattern:
    """Fuse a *chain*: ``stages[:-1]`` produce, ``stages[-1]`` is the
    single terminal.  The chain-shaped front end over
    ``fuse_dag_stages``."""
    terminal = stages[-1]
    return fuse_dag_stages(stages, (terminal.name,), block)[terminal.name]


# --------------------------------------------------------------------------
# TileCopy identity across fused terminal trees
# --------------------------------------------------------------------------


def tile_copy_key(tc: ir.TileCopy):
    """Deduplication key for tile copies of *external tensors*.

    ``insert_tile_copies`` CSEs within one tree, but a DAG pipeline
    fuses one tree per terminal, so two terminals reading the same
    tensor tile carry distinct TileCopy objects (distinct uids) for the
    same copy.  Copies with equal keys move the same data on the same
    schedule and collapse to a single kernel operand / on-chip buffer;
    pattern-valued stages keep uid identity (they are already shared).
    """
    if isinstance(tc.src, ir.Tensor) and isinstance(tc.index_map, AffineMap):
        return ("tensor", tc.src.name, tc.index_map.base, tc.index_map.mat,
                tuple(tc.tile_shape), tc.hoisted)
    return ("uid", tc.uid)
