"""Strip mining: Table 1 of the paper, plus the second pass that turns
statically-predictable accesses into explicit tile copies.

Pass 1 (``strip_mine``) splits each named pattern's domain ``d`` into a
perfectly nested pair: a *strided* outer pattern over ``d/b`` and an
inner pattern over a tile of size ``b``:

    T[ Map(d)(m) ]          = MultiFold(d/b)(d)(zeros(d))
                                { i => (i*b, acc => Map(b)(T[m])) } (_)
    T[ MultiFold(d)(r)(z)(g)(c) ]
                            = MultiFold(d/b)(r)(z)
                                { i => (i', acc => c(acc, MultiFold(b)(r')(z')(T[g])(c))) }(c)
    T[ GroupByFold(d)(z)(h)(c) ]
                            = GroupByFold(d/b)(z){ i => GroupByFold(b)(z)(T[h])(c) }(c)
    T[ FlatMap(d)(f) ]      = FlatMap(d/b){ i => FlatMap(b)(T[f]) }

Pass 2 (``insert_tile_copies``) probes every affine access, splits its
index dependences into *strided* (grid) and *local* dims, and hoists an
explicit ``TileCopy`` to the deepest pattern binding all strided dims it
needs -- the paper's "second strip mining pass" plus the code-motion/CSE
cleanup it assumes.  Non-affine accesses are left in place (they become
cache-backed gathers during hardware generation, not tiling failures).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir, rewrite
from .affine import AffineMap, touched_extent
from .cost import ONCHIP_WORDS

# --------------------------------------------------------------------------
# Pass 1: domain splitting (Table 1)
# --------------------------------------------------------------------------


def _tile_tuple(domain: Tuple[int, ...], sizes) -> Tuple[int, ...]:
    """Resolve per-dim tile sizes; None -> untiled (b = extent)."""
    if sizes is None:
        return tuple(domain)
    if isinstance(sizes, int):
        sizes = (sizes,) + (None,) * (len(domain) - 1)
    assert len(sizes) == len(domain), (sizes, domain)
    out = []
    for d, b in zip(domain, sizes):
        b = d if b is None else b
        assert d % b == 0, (
            f"tile {b} must divide extent {d} (ragged tiles: future min-check)")
        out.append(b)
    return tuple(out)


def _grid_local_xform(enc: int, k: int, tiles: Tuple[int, ...]):
    """Stack transform: callables written against (enc, i_1..i_k) now
    receive (enc, g_1..g_k, l_1..l_k); recover i = g*b + l."""

    def edit(head):
        e = head[:enc]
        g = head[enc:enc + k]
        l = head[enc + k:enc + 2 * k]
        return tuple(e) + tuple(gi * b + li for gi, b, li in zip(g, tiles, l))

    return rewrite.prefix_preserving_tail(edit, enc + 2 * k)


def _recurse_children(p: ir.Pattern, sizes: Dict[str, Sequence],
                      enc: int) -> ir.Pattern:
    """Strip-mine descendants (T[m] recursion) before wrapping ``p``."""
    updates = {}
    if p.inner is not None:
        updates["inner"] = _strip_mine(p.inner, sizes, enc + len(p.domain))
    new_reads, changed = [], False
    for a in p.accesses:
        if isinstance(a.src, ir.Pattern):
            # pattern sources are evaluated with the consumer's full stack
            new_src = _strip_mine(a.src, sizes, enc + len(p.domain))
            if new_src is not a.src:
                a = dataclasses.replace(a, src=new_src)
                changed = True
        new_reads.append(a)
    if changed:
        updates["reads"] = tuple(new_reads)
    return dataclasses.replace(p, **updates) if updates else p


def _strip_mine(p: ir.Pattern, sizes: Dict[str, Sequence],
                enc: int) -> ir.Pattern:
    p = _recurse_children(p, sizes, enc)
    if p.name not in sizes or p.strided:
        return p
    tiles = _tile_tuple(p.domain, sizes[p.name])
    k = len(p.domain)
    grid = tuple(d // b for d, b in zip(p.domain, tiles))
    xform = _grid_local_xform(enc, k, tiles)
    dtype = getattr(torch, p.dtype)

    if isinstance(p, ir.Map):
        inner = ir.Map(
            domain=tiles, elem_shape=p.elem_shape,
            reads=tuple(rewrite._rewrap_access(a, xform) for a in p.reads),
            fn=rewrite.wrap_body_fn(p.fn, xform) if p.fn else None,
            inner=rewrite.rewrap(p.inner, xform) if p.inner else None,
            name=p.name + "_tile", dtype=p.dtype, cuda=p.cuda,
            nearest=p.nearest)
        out_shape = tuple(p.domain) + tuple(p.elem_shape)
        n_elem = len(p.elem_shape)

        def out_map(*stack):
            g = stack[enc:enc + k]
            return tuple(gi * b for gi, b in zip(g, tiles)) + (0,) * n_elem

        return ir.MultiFold(
            domain=grid, range_shape=out_shape,
            init=lambda: torch.zeros(out_shape, dtype=dtype),
            out_index_map=out_map,
            update_shape=tuple(tiles) + tuple(p.elem_shape),
            combine=None,  # write-once: the paper's "(_)"
            inner=inner, strided=True, name=p.name, dtype=p.dtype)

    if isinstance(p, ir.MultiFold):
        # probe the output map: strides of acc location w.r.t. own dims
        amap = AffineMap.probe(p.out_index_map, enc + k)
        own_cols = [amap.col(enc + j) for j in range(k)]
        touched = touched_extent(own_cols, tiles, p.update_shape)
        z_full = torch.as_tensor(p.init())

        def inner_init(_z=z_full, _t=touched):
            # uniform-identity slice of z (z must be combine's identity)
            sl = tuple(slice(0, t) for t in _t)
            return _z[sl].clone()

        def inner_out_map(*stack):
            # relative to the tile's touched-region base
            l = stack[enc + k:enc + 2 * k]
            rel = [0] * amap.n_out
            for j, li in enumerate(l):
                for d_, s in enumerate(own_cols[j]):
                    rel[d_] += s * li
            return tuple(rel)

        inner = ir.MultiFold(
            domain=tiles, range_shape=touched, init=inner_init,
            reads=tuple(rewrite._rewrap_access(a, xform) for a in p.reads),
            out_index_map=inner_out_map, update_shape=tuple(p.update_shape),
            fn=rewrite.wrap_body_fn(p.fn, xform) if p.fn else None,
            combine=p.combine,
            inner=rewrite.rewrap(p.inner, xform) if p.inner else None,
            name=p.name + "_tile", dtype=p.dtype, cuda=p.cuda)

        def outer_out_map(*stack):
            e, g = stack[:enc], stack[enc:enc + k]
            return amap(*(tuple(e) + tuple(gi * b for gi, b in zip(g, tiles))))

        return ir.MultiFold(
            domain=grid, range_shape=tuple(p.range_shape), init=p.init,
            out_index_map=outer_out_map, update_shape=touched,
            combine=p.combine, inner=inner, strided=True,
            name=p.name, dtype=p.dtype)

    if isinstance(p, ir.GroupByFold):
        assert k == 1, "GroupByFold has a 1-D domain"
        inner = ir.GroupByFold(
            domain=tiles, num_keys=p.num_keys, elem_shape=p.elem_shape,
            init=p.init,
            reads=tuple(rewrite._rewrap_access(a, xform) for a in p.reads),
            fn=rewrite.wrap_body_fn(p.fn, xform) if p.fn else None,
            combine=p.combine,
            inner=rewrite.rewrap(p.inner, xform) if p.inner else None,
            name=p.name + "_tile", dtype=p.dtype, cuda=p.cuda,
            keyed_rows=p.keyed_rows)
        return ir.GroupByFold(
            domain=grid, num_keys=p.num_keys, elem_shape=p.elem_shape,
            init=p.init, combine=p.combine, inner=inner, strided=True,
            name=p.name, dtype=p.dtype)

    if isinstance(p, ir.FlatMap):
        assert k == 1, "FlatMap has a 1-D domain"
        inner = ir.FlatMap(
            domain=tiles, max_per_iter=p.max_per_iter,
            elem_shape=p.elem_shape,
            reads=tuple(rewrite._rewrap_access(a, xform) for a in p.reads),
            fn=rewrite.wrap_body_fn(p.fn, xform) if p.fn else None,
            inner=rewrite.rewrap(p.inner, xform) if p.inner else None,
            name=p.name + "_tile", dtype=p.dtype, cuda=p.cuda)
        return ir.FlatMap(
            domain=grid, max_per_iter=tiles[0] * p.max_per_iter,
            elem_shape=p.elem_shape, inner=inner, strided=True,
            name=p.name, dtype=p.dtype)

    raise TypeError(type(p))


def strip_mine(p: ir.Pattern, sizes: Dict[str, Sequence]) -> ir.Pattern:
    """Strip-mine every pattern whose ``name`` appears in ``sizes``.

    ``sizes[name]`` is a per-dim tuple of tile sizes (None = untiled dim).
    """
    return _strip_mine(p, sizes, enc=0)


# --------------------------------------------------------------------------
# Pass 2: tile-copy insertion with code motion + CSE
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Level:
    """One pattern level on the current path."""

    pattern: ir.Pattern
    offset: int          # stack offset of this pattern's indices
    rank: int
    strided: bool


class _CopyCtx:
    def __init__(self, vmem_budget_words: int):
        self.budget = vmem_budget_words
        # (level_id, src_name, sig) -> TileCopy, for CSE
        self.memo: Dict[Tuple, ir.TileCopy] = {}
        # level object id -> list of TileCopy to attach
        self.pending: Dict[int, List[ir.TileCopy]] = {}


def _strided_dims(levels: List[_Level]) -> List[int]:
    dims = []
    for lv in levels:
        if lv.strided:
            dims.extend(range(lv.offset, lv.offset + lv.rank))
    return dims


def _make_copy(ctx: _CopyCtx, levels: List[_Level], a: ir.Access
               ) -> Optional[ir.Access]:
    """Try to convert access ``a`` (owned by levels[-1]) into a tile copy.

    The copy attaches at the deepest level binding a *strided* dim the
    access depends on (code motion).  Dims bound at or above the attach
    level contribute to the copy's base index map; dims bound below are
    covered by the copy's extent.  A copy whose base is constant is
    marked ``hoisted`` (loop-invariant: the Pipe-0 preload of Fig. 6).
    """
    if not a.affine or not isinstance(a.src, ir.Tensor):
        return None
    stack_len = levels[-1].offset + levels[-1].rank
    amap = AffineMap.probe(a.index_map, stack_len)
    deps = set(amap.dependent_dims())
    strided = set(d for d in _strided_dims(levels) if d < stack_len)
    sdeps = sorted(deps & strided)

    attach = 0
    if sdeps:
        for li, lv in enumerate(levels):
            if lv.offset <= sdeps[-1] < lv.offset + lv.rank:
                attach = li
    attach_lv = levels[attach]
    attach_stack = attach_lv.offset + attach_lv.rank

    # dims below the attach level are covered by the copy's extent
    below = sorted(d for d in deps if d >= attach_stack)
    ext_sizes, ext_cols = [], []
    for d in below:
        for lv in levels:
            if lv.offset <= d < lv.offset + lv.rank:
                ext_sizes.append(lv.pattern.domain[d - lv.offset])
        ext_cols.append(amap.col(d))
    tile_shape = touched_extent(ext_cols, ext_sizes, a.window)
    if int(np.prod(tile_shape)) > ctx.budget:
        return None  # stream it: tile would not fit on chip

    # copy base: columns of dims bound at/above attach; zero elsewhere
    copy_mat = tuple(
        tuple(amap.col(d_in)[d_out] if d_in < attach_stack else 0
              for d_in in range(attach_stack))
        for d_out in range(amap.n_out))
    copy_map = AffineMap(amap.base, copy_mat, arity=attach_stack)
    hoisted = all(all(m == 0 for m in row) for row in copy_mat)

    sig = (id(a.src), copy_map.base, copy_map.mat, tile_shape)
    key = (id(attach_lv.pattern), sig)
    if key in ctx.memo:
        tc = ctx.memo[key]
    else:
        tc = ir.TileCopy(src=a.src, index_map=copy_map,
                         tile_shape=tile_shape, hoisted=hoisted,
                         name=f"{a.src.name}_tile")
        ctx.memo[key] = tc
        ctx.pending.setdefault(id(attach_lv.pattern), []).append(tc)

    # rewritten access: below-attach dims only, relative to the tile base
    local_mat = tuple(
        tuple(amap.col(d_in)[d_out] if d_in in below else 0
              for d_in in range(stack_len))
        for d_out in range(amap.n_out))
    local_map = AffineMap((0,) * amap.n_out, local_mat, arity=stack_len)
    return dataclasses.replace(a, src=tc, index_map=local_map)


def _insert_copies(p: ir.Pattern, levels: List[_Level],
                   ctx: _CopyCtx) -> ir.Pattern:
    me = _Level(p, offset=(levels[-1].offset + levels[-1].rank) if levels
                else 0, rank=len(p.domain), strided=p.strided)
    path = levels + [me]

    new_reads = []
    for a in p.accesses:
        res = _make_copy(ctx, path, a)
        if res is not None:
            new_reads.append(res)
        elif isinstance(a.src, ir.Pattern):
            # pattern sources are evaluated with the consumer's full stack
            new_reads.append(dataclasses.replace(
                a, src=_insert_copies(a.src, path, ctx)))
        else:
            new_reads.append(a)
    updates: Dict = {"reads": tuple(new_reads)}

    # pattern-valued tile loads (lifted stages) are evaluated at this
    # level: recurse BEFORE collecting copies attached here
    new_loads = []
    for tc in p.loads:
        if isinstance(tc.src, ir.Pattern):
            tc = dataclasses.replace(tc, src=_insert_copies(tc.src, path, ctx))
        new_loads.append(tc)

    if p.inner is not None:
        updates["inner"] = _insert_copies(p.inner, path, ctx)

    mine = ctx.pending.pop(id(p), [])
    updates["tile_loads"] = tuple(new_loads) + tuple(mine)
    return dataclasses.replace(p, **updates)


def insert_tile_copies(p: ir.Pattern, *,
                       vmem_budget_words: int = ONCHIP_WORDS
                       ) -> ir.Pattern:
    """Pass 2: explicit tile copies for statically-predictable accesses.

    Copies requested by descendants get attached to the ancestor pattern
    whose strided indices they depend on (code motion) and identical
    copies are merged (CSE).  Default budget: the default tier's
    on-chip bytes in 4 B words.
    """
    ctx = _CopyCtx(vmem_budget_words)
    out = _insert_copies(p, [], ctx)
    assert not ctx.pending, "unattached tile copies (hoist level bug)"
    return out


def tile(p: ir.Pattern, sizes: Dict[str, Sequence], *,
         apply_interchange: bool = True,
         vmem_budget_words: int = ONCHIP_WORDS) -> ir.Pattern:
    """Full tiling pipeline (paper Fig. 1 "high level transformations"):
    strip-mine -> lift tile stages (split heuristic) -> interchange ->
    insert tile copies (code motion + CSE)."""
    from .fusion import lift_tile_stages  # local imports: avoid cycles
    from .interchange import interchange as _interchange
    out = strip_mine(p, sizes)
    if apply_interchange:
        out = lift_tile_stages(out, vmem_budget_words=vmem_budget_words)
        out = _interchange(out, vmem_budget_words=vmem_budget_words)
    return insert_tile_copies(out, vmem_budget_words=vmem_budget_words)
