"""Parallel Pattern Language (PPL) intermediate representation.

This is the IR from "Generating Configurable Hardware from Parallel
Patterns" (Prabhakar et al., 2015), Figure 2, as the PyTorch/CUDA port
carries it:

    Map(d)(m)                 : V_D   -- one value per index, fixed range
    MultiFold(d)(r)(z)(f)(c)  : V_R   -- fold generated values into a region
                                         of a larger accumulator
    FlatMap(d)(n)             : V_1   -- dynamic-size concat (1-D domain)
    GroupByFold(d)(z)(g)(c)   : (K,V) -- keyed fold (1-D domain)

Design notes:

* Pattern *bodies* are torch callables written for a batch of indices:
  every window argument may carry leading batch dimensions, so a body
  broadcasts over them (``codegen_torch`` evaluates a whole Map domain
  in one call).  *Access patterns* are explicit ``Access`` descriptors
  (an index map + window).  ``repro_torch.patterns`` builds them the
  way the Delite DSL frontend of the paper would have.
* ``cuda`` is the same body as CUDA C++ statements, spliced by
  ``codegen_cuda`` into a hand-written template (the paper's template
  instantiation).  The body sees its reads as ``const float* in0, in1,
  ...`` (each a contiguous window, row-major) and writes ``float*
  out``: a Map body its element's words; a GroupByFold body the value
  and ``int& key``; a fold body the per-index contribution its ``+``
  combine adds; a FlatMap body up to ``max_per_iter`` values and ``int&
  count``, the number of leading values kept.  A CUDA body does not
  read the index stack.
* Transformations (strip mining, interchange) are structural rewrites on
  the pattern tree; nesting is explicit: an outer pattern whose body is
  another pattern carries it in ``inner`` with a list of ``TileCopy``
  load stages, mirroring the paper's tiled IR.
* Dynamic structures are bounded: FlatMap bodies declare a static
  ``max_per_iter`` (mask + compaction replaces the FPGA parallel FIFO)
  and GroupByFold declares ``num_keys`` (a dense table replaces the
  FPGA CAM).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------
# Symbolic tensors and accesses
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Tensor:
    """A symbolic dense array living in main (HBM / off-chip) memory."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __repr__(self) -> str:  # compact for transformation-rule tests
        return f"{self.name}:{'x'.join(map(str, self.shape))}"


_UID = itertools.count()


def _next_uid() -> str:
    return f"tc{next(_UID)}"


@dataclass(frozen=True)
class TileCopy:
    """An explicit on-chip copy of a tile of ``src`` (paper: ``x.copy(b+ii,*)``).

    ``index_map`` maps the *outer* (strided) domain index to the element
    offset of the tile; ``tile_shape`` is the copied region.  It is the
    tile a kernel stages on chip (shared memory on the GPU) and what the
    memory-allocation pass turns into a (multi-)buffer.

    ``reuse`` marks overlapping tiles (e.g. sliding windows) whose
    generation rules avoid redundant main-memory reads.
    """

    src: Union[Tensor, "Pattern"]
    index_map: Callable[..., Tuple[int, ...]]
    tile_shape: Tuple[int, ...]
    name: str = "tile"
    reuse: int = 1
    hoisted: bool = False  # loop-invariant: loaded once (Fig. 6 "Pipe 0")
    # stable identity across tree rewrites (dataclasses.replace keeps it):
    # an access's src copy and the (possibly rebuilt) load in tile_loads
    # refer to the same on-chip buffer iff uids match.
    uid: str = field(default_factory=_next_uid)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.tile_shape

    @property
    def dtype(self) -> str:
        return self.src.dtype

    @property
    def words(self) -> int:
        return int(np.prod(self.tile_shape))

    def __repr__(self) -> str:
        src = self.src.name if isinstance(self.src, Tensor) else "<pattern>"
        return f"copy({src}, {'x'.join(map(str, self.tile_shape))})"


Source = Union[Tensor, TileCopy, "Pattern"]


@dataclass(frozen=True)
class Access:
    """A read of ``src`` performed at every index of a pattern's domain.

    ``index_map(idx) -> start offsets`` and ``window`` describe the region
    read per iteration.  ``affine=False`` marks data-dependent (gather)
    accesses -- these are the cases polyhedral tiling rejects and the
    paper handles by inferring caches / CAMs; we keep them out of tile
    copies and lower them to gathers.
    """

    src: Source
    index_map: Callable[..., Tuple[int, ...]]
    window: Tuple[int, ...]
    affine: bool = True
    name: str = ""

    @property
    def words(self) -> int:
        return int(np.prod(self.window))


def whole(src: Source) -> Access:
    """Access reading the entire source every iteration."""
    shape = src.shape
    return Access(src, lambda *i: (0,) * len(shape), shape, affine=True)


def row(src: Source, dim: int = 0) -> Access:
    """Access reading row ``idx`` along ``dim`` (1-D domain)."""
    shape = src.shape

    def imap(i):
        start = [0] * len(shape)
        start[dim] = i
        return tuple(start)

    window = tuple(1 if d == dim else s for d, s in enumerate(shape))
    return Access(src, imap, window, affine=True)


def elem(src: Source) -> Access:
    """Access reading the single element at the domain index."""
    shape = src.shape
    return Access(src, lambda *i: tuple(i), (1,) * len(shape), affine=True)


# --------------------------------------------------------------------------
# Patterns
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RaggedExtent:
    """A bounded-dynamic streaming extent (serving decode: per-request
    ``seq_len``).

    The pattern's static ``domain`` stays at the upper bound ``max`` --
    tiling, memory planning and the grid all see a static extent -- but
    at run time only the leading ``length_name`` elements are live.
    Codegen keeps the static grid and predicates in-kernel (elements
    past the length are masked); the cost model prices traffic at the
    ``granularity``-rounded live extent instead of the bound (a paged
    KV cache streams whole pages, so ``granularity`` = page size).
    """

    max: int
    length_name: str       # runtime scalar input holding the live extent
    granularity: int = 1   # mask granularity (page size); divides traffic

    @property
    def max_units(self) -> int:
        """Upper bound in granularity units (static page-count grid)."""
        return -(-self.max // self.granularity)


@dataclass(frozen=True)
class Pattern:
    """Base class; ``domain`` is the iteration space extent."""

    domain: Tuple[int, ...]
    cuda: Optional[str] = None  # CUDA C++ body (see module docstring)

    @property
    def trip_count(self) -> int:
        return int(np.prod(self.domain))

    # sources read by the body at every domain index
    @property
    def accesses(self) -> Tuple[Access, ...]:
        return getattr(self, "reads", ())

    @property
    def loads(self) -> Tuple[TileCopy, ...]:
        """Tile copies hoisted into this pattern's body (post strip-mining)."""
        return getattr(self, "tile_loads", ())


@dataclass(frozen=True)
class Map(Pattern):
    """``Map(d)(m) : V_D`` -- one value of shape ``elem_shape`` per index.

    Output shape is ``domain + elem_shape`` (elem_shape=() for scalars).
    ``fn(idx, *windows) -> value`` where ``windows`` are the regions named
    by ``reads`` (tensors of ``Access.window`` shape, squeezed, behind
    any batch dimensions).
    """

    elem_shape: Tuple[int, ...] = ()
    reads: Tuple[Access, ...] = ()
    fn: Optional[Callable] = None
    tile_loads: Tuple[TileCopy, ...] = ()
    inner: Optional["Pattern"] = None  # nested per-element pattern / tiled body
    strided: bool = False  # True for grid (strip-mined outer) domains
    name: str = "map"
    dtype: str = "float32"
    ragged: Optional[RaggedExtent] = None  # bounded-dynamic 1-D domain
    # (table read, query read): the value is the index of the table row
    # nearest the query row in squared Euclidean distance, the first of
    # equal ones -- an argmin fold over the table's rows that the fused
    # lowering strip-mines into tiles of rows (``fn`` and ``cuda`` state
    # the same value for the other paths)
    nearest: Optional[Tuple[int, int]] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.domain) + tuple(self.elem_shape)


@dataclass(frozen=True)
class MultiFold(Pattern):
    """``MultiFold(d)(r)(z)(f)(c) : V_R``.

    Per index the body produces ``(out_index, update)`` where ``update``
    consumes the current accumulator slice of shape ``update_shape`` at
    ``out_index`` and returns its new value.  ``combine`` merges parallel
    partial accumulators (must be associative; ``init`` its identity).

    ``fn(idx, acc_slice, *windows) -> new_slice``;
    ``out_index_map(idx) -> start offsets`` into the ``range_shape`` acc.
    A classic ``fold`` is the special case ``update_shape == range_shape``
    and ``out_index_map == lambda *i: zeros`` (every iteration updates the
    whole accumulator) -- test with ``is_fold``.
    ``combine=None`` marks the write-once case (strided tiled Map), shown
    as ``(_)`` in the paper's Table 1.
    """

    range_shape: Tuple[int, ...] = ()
    init: Optional[Callable[[], Any]] = None
    reads: Tuple[Access, ...] = ()
    out_index_map: Optional[Callable] = None
    update_shape: Tuple[int, ...] = ()
    fn: Optional[Callable] = None
    combine: Optional[Callable] = None
    tile_loads: Tuple[TileCopy, ...] = ()
    inner: Optional["Pattern"] = None
    strided: bool = False
    name: str = "multifold"
    dtype: str = "float32"
    ragged: Optional[RaggedExtent] = None  # bounded-dynamic 1-D domain

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.range_shape)

    @property
    def is_fold(self) -> bool:
        return tuple(self.update_shape) == tuple(self.range_shape)


@dataclass(frozen=True)
class FlatMap(Pattern):
    """``FlatMap(d)(n) : V_1`` -- 1-D domain, dynamic output size.

    Bounded form: ``fn(idx, *windows) -> (values, count)`` with
    ``values.shape == (max_per_iter,) + elem_shape`` and ``count`` the
    number of valid leading entries.  Output realizes as a static
    ``(domain * max_per_iter,)`` buffer plus a total count (the FPGA
    parallel FIFO becomes mask + prefix-sum compaction).
    """

    max_per_iter: int = 1
    elem_shape: Tuple[int, ...] = ()
    reads: Tuple[Access, ...] = ()
    fn: Optional[Callable] = None
    tile_loads: Tuple[TileCopy, ...] = ()
    inner: Optional["Pattern"] = None
    strided: bool = False
    name: str = "flatmap"
    dtype: str = "float32"

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.trip_count * self.max_per_iter,) + tuple(self.elem_shape)


@dataclass(frozen=True)
class GroupByFold(Pattern):
    """``GroupByFold(d)(z)(g)(c) : (K,V)_1`` -- keyed fold, 1-D domain.

    The key space is bounded by ``num_keys`` so the accumulator realizes
    as a dense ``(num_keys,) + elem_shape`` table (replacing the FPGA
    CAM); keys outside ``[0, num_keys)`` are dropped by the kernel.
    ``fn(idx, *windows) -> (key, value)``; ``combine(a, b)`` elementwise.
    """

    num_keys: int = 1
    elem_shape: Tuple[int, ...] = ()
    init: Optional[Callable[[], Any]] = None
    reads: Tuple[Access, ...] = ()
    fn: Optional[Callable] = None
    combine: Optional[Callable] = None
    tile_loads: Tuple[TileCopy, ...] = ()
    inner: Optional["Pattern"] = None
    strided: bool = False
    name: str = "groupbyfold"
    dtype: str = "float32"
    # (key read, value read): the key is the element of the first read
    # (an integer-valued float) and the value is the second read's window
    # as it is -- a keyed sum of rows, which the fused lowering may fold
    # a column slice at a time (``fn`` and ``cuda`` state the same)
    keyed_rows: Optional[Tuple[int, int]] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_keys,) + tuple(self.elem_shape)


PATTERN_TYPES = (Map, MultiFold, FlatMap, GroupByFold)


# --------------------------------------------------------------------------
# Traversal / structural helpers
# --------------------------------------------------------------------------


def children(p: Pattern) -> Tuple[Pattern, ...]:
    out = []
    if p.inner is not None:
        out.append(p.inner)
    for tc in p.loads:
        if isinstance(tc.src, Pattern):
            out.append(tc.src)
    for a in p.accesses:
        if isinstance(a.src, Pattern):
            out.append(a.src)
    return tuple(out)


def walk(p: Pattern):
    """Pre-order traversal of the pattern tree."""
    yield p
    for c in children(p):
        yield from walk(c)


def nesting_depth(p: Pattern) -> int:
    d = 1
    while p.inner is not None:
        d += 1
        p = p.inner
    return d


def inputs_of(p: Pattern) -> Tuple[Tensor, ...]:
    """All main-memory tensors read anywhere in the tree (dedup, ordered)."""
    seen: dict = {}
    for node in walk(p):
        for a in node.accesses:
            if isinstance(a.src, Tensor):
                seen.setdefault(a.src.name, a.src)
        for tc in node.loads:
            if isinstance(tc.src, Tensor):
                seen.setdefault(tc.src.name, tc.src)
    return tuple(seen.values())


def describe(p: Pattern, indent: int = 0) -> str:
    """Structural pretty-printer used by the transformation-rule tests."""
    pad = "  " * indent
    kind = type(p).__name__
    dom = "x".join(map(str, p.domain))
    extra = ""
    if isinstance(p, MultiFold):
        extra = f" range={'x'.join(map(str, p.range_shape)) or 'scalar'}"
        if p.combine is None:
            extra += " (_)"
        if p.is_fold:
            extra += " [fold]"
    if isinstance(p, GroupByFold):
        extra = f" keys={p.num_keys}"
    lines = [f"{pad}{kind}({dom}){extra}"]
    for tc in p.loads:
        lines.append(f"{pad}  {tc!r}" + (" [hoisted]" if tc.hoisted else ""))
        if isinstance(tc.src, Pattern):
            lines.append(describe(tc.src, indent + 2))
    for a in p.accesses:
        if isinstance(a.src, Pattern):
            lines.append(f"{pad}  <src pattern>")
            lines.append(describe(a.src, indent + 2))
    if p.inner is not None:
        lines.append(describe(p.inner, indent + 1))
    return "\n".join(lines)


def signature(p: Pattern) -> Tuple:
    """Hashable structural signature (used for CSE of tile copies and in
    rule tests: two IRs are structurally equal iff signatures match)."""
    sig: Tuple = (type(p).__name__, tuple(p.domain))
    if isinstance(p, MultiFold):
        sig += (tuple(p.range_shape), p.combine is None)
    if isinstance(p, GroupByFold):
        sig += (p.num_keys,)
    sig += (tuple((repr(tc)) for tc in p.loads),)
    rag = getattr(p, "ragged", None)
    if rag is not None:   # appended only when present: static-extent
        sig += (("ragged", rag.max, rag.length_name, rag.granularity),)
    if p.inner is not None:
        sig += (signature(p.inner),)
    return sig
