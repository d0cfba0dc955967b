"""Generic pattern-tree rewriting utilities.

Transformations need to (a) rebuild frozen pattern nodes with changed
fields and (b) re-wrap every index-sensitive callable in a subtree when
the enclosing index stack changes shape (strip mining inserts grid+local
index pairs; interchange permutes stack segments).

A *stack transform* is a function ``new_stack -> old_stack`` mapping the
indices a callable will now receive to the indices it was written
against.  ``rewrap`` applies one to every callable in a subtree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from . import ir

StackXform = Callable[[Tuple], Tuple]


def compose(f: StackXform, g: StackXform) -> StackXform:
    return lambda s: g(f(s))


def wrap_index_map(index_map: Callable, xform: StackXform) -> Callable:
    def wrapped(*stack):
        return index_map(*xform(tuple(stack)))

    return wrapped


def wrap_body_fn(fn: Callable, xform: StackXform) -> Callable:
    """Body fns take the stack as their first (tuple) argument."""

    def wrapped(stack, *rest):
        return fn(xform(tuple(stack)), *rest)

    return wrapped


def _rewrap_access(a: ir.Access, xform: StackXform) -> ir.Access:
    src = a.src
    if isinstance(src, ir.Pattern):
        src = rewrap(src, xform)
    return dataclasses.replace(
        a, src=src, index_map=wrap_index_map(a.index_map, xform))


def _rewrap_tilecopy(tc: ir.TileCopy, xform: StackXform) -> ir.TileCopy:
    src = tc.src
    if isinstance(src, ir.Pattern):
        src = rewrap(src, xform)
    return dataclasses.replace(
        tc, src=src, index_map=wrap_index_map(tc.index_map, xform))


def rewrap(p: ir.Pattern, xform: StackXform) -> ir.Pattern:
    """Re-wrap every callable in the subtree rooted at ``p`` so that it
    translates the *new* incoming stack back to the stack layout it was
    originally written against.  The transform applies uniformly to the
    whole subtree because enclosing indices are a prefix of every nested
    stack: ``xform`` must preserve any suffix beyond the region it edits
    (our xforms operate on a fixed prefix and pass the tail through).
    """
    updates = {}
    updates["reads"] = tuple(_rewrap_access(a, xform) for a in p.accesses)
    updates["tile_loads"] = tuple(
        _rewrap_tilecopy(t, xform) for t in p.loads)
    if p.fn is not None:
        updates["fn"] = wrap_body_fn(p.fn, xform)
    if isinstance(p, ir.MultiFold) and p.out_index_map is not None:
        updates["out_index_map"] = wrap_index_map(p.out_index_map, xform)
    if p.inner is not None:
        updates["inner"] = rewrap(p.inner, xform)
    return dataclasses.replace(p, **updates)


def prefix_preserving_tail(edit: Callable[[Tuple], Tuple],
                           edit_len: int) -> StackXform:
    """Build a StackXform that applies ``edit`` to the first ``edit_len``
    entries of the stack and passes any remaining (deeper-nested) indices
    through unchanged."""

    def xform(stack: Tuple) -> Tuple:
        head, tail = tuple(stack[:edit_len]), tuple(stack[edit_len:])
        return tuple(edit(head)) + tail

    return xform


def map_tree(p: ir.Pattern, fn: Callable[[ir.Pattern], Optional[ir.Pattern]]
             ) -> ir.Pattern:
    """Bottom-up rebuild: ``fn`` may return a replacement for each node."""
    updates = {}
    if p.inner is not None:
        updates["inner"] = map_tree(p.inner, fn)
    new_reads = []
    changed = False
    for a in p.accesses:
        if isinstance(a.src, ir.Pattern):
            new_src = map_tree(a.src, fn)
            if new_src is not a.src:
                a = dataclasses.replace(a, src=new_src)
                changed = True
        new_reads.append(a)
    if changed:
        updates["reads"] = tuple(new_reads)
    if updates:
        p = dataclasses.replace(p, **updates)
    out = fn(p)
    return out if out is not None else p
