"""Pattern interchange: the two Collect-Reduce reordering rules (§4).

Both rules match the special case of MultiFold where every iteration
updates the entire accumulator (a *fold*) and move strided patterns out
of unstrided ones to increase tile reuse:

  Rule 1:  Map(d_m){ fold(d_f/b)(z)(body)(c) }
        -> fold(d_f/b)(bcast z){ Map(d_m){ body } }(lifted c)
     (a scalar strided fold moves out of an unstrided Map; the fold's
      combine becomes a Map -- realized here by requiring combines to be
      shape-polymorphic elementwise functions)

  Rule 2:  fold(d_f){ MultiFold_writeonce(d_m/b){ body } }
        -> MultiFold_writeonce(d_m/b){ fold(d_f){ body } }
     (the outer pattern of a tiled Map moves out of an unstrided fold)

Interchange runs between strip mining and tile-copy insertion, so
matched nodes carry no tile loads yet.  The index-stack segments of the
two patterns swap; every callable in the moved subtrees is re-wrapped.

The imperfect-nesting *split* heuristic (split fused bodies only when
the intermediate fits on-chip) is exposed as ``should_split`` and is
applied by the frontend when building fused programs (our bodies are
opaque tile-level functions, so splitting happens at construction
time).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import ir, rewrite
from .cost import ONCHIP_WORDS


def _swap_xform(enc: int, k_first: int, k_second: int):
    """Callables written against (enc, A[k_first], B[k_second], tail) now
    receive (enc, B, A, tail)."""

    def edit(head):
        e = head[:enc]
        b = head[enc:enc + k_second]
        a = head[enc + k_second:enc + k_second + k_first]
        return tuple(e) + tuple(a) + tuple(b)

    return rewrite.prefix_preserving_tail(edit, enc + k_first + k_second)


def _is_unstrided_map(p: ir.Pattern) -> bool:
    return isinstance(p, ir.Map) and not p.strided


def _is_strided_fold(p: ir.Pattern) -> bool:
    return (isinstance(p, ir.MultiFold) and p.strided and p.is_fold
            and p.combine is not None)


def _is_unstrided_fold(p: ir.Pattern) -> bool:
    return (isinstance(p, ir.MultiFold) and not p.strided and p.is_fold
            and p.combine is not None)


def _is_strided_writeonce(p: ir.Pattern) -> bool:
    return isinstance(p, ir.MultiFold) and p.strided and p.combine is None


def _rule1(m: ir.Map, enc: int) -> Optional[ir.MultiFold]:
    """Move a strided fold out of an unstrided Map."""
    f = m.inner
    if not (_is_unstrided_map(m) and f is not None and _is_strided_fold(f)):
        return None
    if m.reads or f.reads or m.fn is not None or f.fn is not None:
        return None  # only the post-strip-mine canonical shape
    km, kf = len(m.domain), len(f.domain)
    xform = _swap_xform(enc, km, kf)

    new_range = tuple(m.domain) + tuple(f.range_shape)
    z_elem = torch.as_tensor(f.init())
    z_new = torch.broadcast_to(z_elem, new_range).clone()

    inner_map = ir.Map(
        domain=tuple(m.domain), elem_shape=tuple(f.range_shape),
        inner=rewrite.rewrap(f.inner, xform) if f.inner else None,
        name=m.name, dtype=m.dtype)

    return ir.MultiFold(
        domain=tuple(f.domain), range_shape=new_range,
        init=lambda _z=z_new: _z.clone(),
        out_index_map=lambda *s: (0,) * len(new_range),
        update_shape=new_range,
        combine=f.combine,  # shape-polymorphic elementwise lift
        inner=inner_map, strided=True,
        name=f.name, dtype=f.dtype)


def _rule2(f: ir.MultiFold, enc: int) -> Optional[ir.MultiFold]:
    """Move the (strided, write-once) outer of a tiled Map out of an
    unstrided fold."""
    w = f.inner
    if not (_is_unstrided_fold(f) and w is not None
            and _is_strided_writeonce(w)):
        return None
    if f.reads or w.reads or f.fn is not None or w.fn is not None:
        return None
    kf, kw = len(f.domain), len(w.domain)
    xform = _swap_xform(enc, kf, kw)

    # per-tile fold: reduces the tile slice across the unstrided domain
    z_full = torch.as_tensor(f.init())
    upd = tuple(w.update_shape)

    def tile_init(_z=z_full, _u=upd):
        sl = tuple(slice(0, t) for t in _u)
        return _z[sl].clone()  # uniform identity

    inner_fold = ir.MultiFold(
        domain=tuple(f.domain), range_shape=upd, init=tile_init,
        out_index_map=lambda *s: (0,) * len(upd), update_shape=upd,
        combine=f.combine,
        inner=rewrite.rewrap(w.inner, xform) if w.inner else None,
        name=f.name, dtype=f.dtype)

    def out_xf(head):
        # w.out_index_map was written against (enc, f, w); f is no longer
        # bound -- legal only if the map ignores f dims (checked by probe)
        return tuple(head[:enc]) + (0,) * kf + tuple(head[enc:enc + kw])

    from .affine import AffineMap
    probe = AffineMap.probe(w.out_index_map, enc + kf + kw)
    if any(probe.depends_on(enc + j) for j in range(kf)):
        return None  # output location depends on the fold index: no-go

    return ir.MultiFold(
        domain=tuple(w.domain), range_shape=tuple(w.range_shape),
        init=f.init,
        out_index_map=rewrite.wrap_index_map(
            w.out_index_map,
            rewrite.prefix_preserving_tail(out_xf, enc + kw)),
        update_shape=upd, combine=None, inner=inner_fold,
        strided=True, name=w.name, dtype=w.dtype)


def interchange(p: ir.Pattern, *, enc: int = 0,
                vmem_budget_words: int = ONCHIP_WORDS) -> ir.Pattern:
    """Apply rules 1/2 wherever they match, innermost first, repeatedly.

    Rule 1 grows the accumulator from ``f.range`` to ``m.domain+f.range``
    (the paper: a (dist,label) pair becomes a tile of pairs); it is
    applied only when the grown intermediate fits on-chip -- the paper's
    split heuristic.
    """

    def visit(node: ir.Pattern, enc_: int) -> ir.Pattern:
        # rebuild children first (post-order) with correct enclosing rank
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
        tl, ch2 = [], False
        for tc in node.loads:
            if isinstance(tc.src, ir.Pattern):
                ns = visit(tc.src, enc_ + len(node.domain))
                if ns is not tc.src:
                    tl.append(dataclasses.replace(tc, src=ns))
                    ch2 = True
                    continue
            tl.append(tc)
        if ch2:
            updates["tile_loads"] = tuple(tl)
        if updates:
            node = dataclasses.replace(node, **updates)

        out = _rule1(node, enc_) if isinstance(node, ir.Map) else None
        if out is not None:
            grown = int(np.prod(out.range_shape))
            if grown <= vmem_budget_words:
                return visit(out, enc_)  # re-check: rules may now fire above
            return node
        if isinstance(node, ir.MultiFold):
            out = _rule2(node, enc_)
            if out is not None:
                return visit(out, enc_)
        return node

    return visit(p, enc)


def should_split(intermediate_words: int,
                 vmem_budget_words: int = ONCHIP_WORDS) -> bool:
    """The paper's split heuristic: split-and-interchange imperfectly
    nested patterns only when the intermediate created by the split is
    statically known to fit on-chip."""
    return intermediate_words <= vmem_budget_words
