"""Hardware generation: lower tiled PPL IR to hand-written CUDA templates.

This is the paper's §5 code generation step with CUDA templates in the
place of MaxJ ones, for an NVIDIA Hopper card (``sm_90a``):

  * the tiled GEMM (Table 3 form)          -> ``csrc/tiled_gemm.cuh``,
    one block per output tile looping over K itself through a
    ``depth``-slot ``cp.async`` ring (the metapipeline)
  * a write-once tiled Map                 -> ``csrc/tiled_map.cuh``,
    persistent blocks staging each grid step's tiles in rotating shared
    slots and writing one output block per step
  * a tiled GroupByFold (CAM)              -> ``csrc/fused_dag.cuh`` with
    one CAM terminal: per-warp tables without atomics, partials summed
    in order
  * a tiled FlatMap (parallel FIFO)        -> ``csrc/tiled_flatmap.cuh``,
    one pass: tiles through a ``cp.async`` ring, each tile counted,
    its offset found by decoupled look-back across blocks and its kept
    values compacted, in one cooperative launch
  * a fused pipeline DAG (``lower_fused_dag``) -> ``csrc/fused_dag.cuh``,
    one persistent multi-output megakernel: streamed tiles through a
    ``depth``-slot ``cp.async`` ring, producer stages in shared-memory
    scratch, fold terminals in registers, CAM terminals in per-warp
    tables (registers, or shared memory for large ones) without atomics,
    Map terminals streamed out once; per-block partials are summed in
    block order by a second small launch; a call repeated on the same
    inputs replays the two launches as one CUDA graph
  * one serving decode step of one layer over a paged KV cache
    (``lower_paged_decode``)             -> ``csrc/paged_decode.cuh``,
    the request's live pages split across blocks (flash-decoding), each
    streaming its part through a ``cp.async`` ring with an online softmax,
    the parts merged by a combine kernel

``lower`` picks the template for a tiled pattern and ``lower_auto``
tiles an untiled one with the single-pattern DSE first.  The generator
instantiates a template per program and plan: it splices each pattern's
CUDA body (``ir.Pattern.cuda``) and the plan's constants into one
translation unit, which ``kernels.build`` compiles with nvcc and caches
by hash.  Every kernel has a wrapper that launches it for CUDA tensors
(or raises), a plain PyTorch version of the same function that the
wrapper takes for CPU tensors only, and a launch count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import operator
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir, memory, resilience, telemetry
from .affine import AffineMap
from ..device import resolve
from ..kernels import build
from ..kernels.grid_flags import Flags
from .cost import DEFAULT_TIER
from .dse import PAGED_LAYOUTS


def _f32(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"'{name}': expected a contiguous float32 tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _on(tensors: Sequence[torch.Tensor]) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _aligned(named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """The templates read their inputs in 16-byte pieces, so each must
    start on a 16-byte boundary, as a fresh allocation does; a view at
    another offset is refused (``_staged`` copies it)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(
                f"'{name}' starts {t.data_ptr() % 16} bytes past a 16-byte "
                "boundary; the CUDA kernels read 16-byte aligned inputs")


def _staged(t, dev: torch.device) -> torch.Tensor:
    """``t`` as a kernel input on ``dev``: contiguous and, on the card,
    16-byte aligned (a view at another offset is copied)."""
    t = torch.as_tensor(t).to(dev).contiguous()
    return build.aligned(t) if dev.type == "cuda" else t


def _persistent_ctas(library: Callable, fn: str, smem_bytes: int,
                     dev: torch.device, what: str) -> int:
    """The persistent block count a kernel's ``<prefix>_ctas`` entry
    point computes on ``dev``.  Raises before building when the card's
    shared memory per block is smaller than the plan's."""
    props = torch.cuda.get_device_properties(dev)
    if smem_bytes > props.shared_memory_per_block_optin:
        raise ValueError(
            f"{what} needs {smem_bytes} B of shared memory; the card "
            f"allows {props.shared_memory_per_block_optin} B per block")
    lib = library()
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        build.check(lib, getattr(lib, fn)(ctypes.byref(n)),
                    f"{what} occupancy")
    return n.value


def _ctas_source(prefix: str, main: str, smem: str,
                 others: Sequence[str] = ()) -> str:
    """``extern "C" int <prefix>_ctas(int*)``: opt every kernel into the
    card's largest dynamic shared memory, then the persistent block
    count of ``main`` at ``smem`` bytes -- a few per SM as occupancy
    allows (``tcopy::blocks_per_sm``), at most one per grid step
    (``GRID``)."""
    opts = "".join(f"  if ((e = tcopy::opt_in({k})) != 0) return e;\n"
                   for k in others)
    return f'''extern "C" int {prefix}_ctas(int* ctas) {{
  int e, dev = 0, sms = 0, per_sm = 0;
{opts}  if ((e = tcopy::blocks_per_sm({main}, {smem}, &per_sm)) != 0) return e;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  long long n = (long long)sms * per_sm;
  *ctas = (int)(n < GRID ? n : GRID);
  return 0;
}}
'''


# --------------------------------------------------------------------
# Tiled GEMM (Table 3 interchanged form):
#   MultiFold(gi,gj) write-once { MultiFold(kk) fold { Map(bi,bj){fold} } }
# --------------------------------------------------------------------


def match_tiled_gemm(p: ir.Pattern) -> bool:
    return (isinstance(p, ir.MultiFold) and p.strided and p.combine is None
            and isinstance(p.inner, ir.MultiFold) and p.inner.strided
            and p.inner.is_fold and isinstance(p.inner.inner, ir.Map))


GEMM_XPAD = 4           # tgemm::XPAD: words of padding per staged x row
GEMM_MIN_THREADS = 128  # tgemm::MIN_THREADS


@dataclasses.dataclass(frozen=True)
class GemmLayout:
    """The GEMM template's shape at a plan's tile (``tgemm::Tile``)."""

    tm: int            # micro-tile rows per thread
    tn: int            # micro-tile columns per thread
    threads: int
    smem_bytes: int    # depth x (bm x (bk + XPAD) + bk x bn) x 4
    pad_bytes: int     # of which the x rows' padding: depth x bm x XPAD x 4


def gemm_layout(bm: int, bn: int, bk: int, depth: int) -> GemmLayout:
    """The template's micro-tile, threads and shared bytes at tile
    ``(bm, bn, bk)`` and metapipeline ``depth``: the first of 8x8, 8x4,
    4x4 that divides the tile and leaves it at least 128 threads, else
    4x4; ``depth`` slots of one x slab (rows padded by GEMM_XPAD words)
    and one y slab."""
    for tm, tn in ((8, 8), (8, 4), (4, 4)):
        if bm % tm == 0 and bn % tn == 0 \
                and (bm // tm) * (bn // tn) >= GEMM_MIN_THREADS:
            break
    else:
        tm, tn = 4, 4
    pad = depth * bm * GEMM_XPAD * 4
    return GemmLayout(tm, tn, (bm // tm) * (bn // tn),
                      depth * (bm * bk + bk * bn) * 4 + pad, pad)


def gemm_source(bm: int, bn: int, bk: int, depth: int) -> str:
    """The translation unit instantiating the GEMM template at a tile and
    metapipeline depth."""
    args = f"{bm}, {bn}, {bk}, {depth}"
    return f'''// tiled GEMM at tile ({bm}, {bn}, {bk}), depth {depth}, generated by codegen_cuda
#include "tiled_gemm.cuh"

extern "C" int gemm_launch(const void* x, const void* y, void* out, int m,
                           int n, int k, void* stream) {{
  return tgemm::launch<{args}>(
      (const float*)x, (const float*)y, (float*)out, m, n, k,
      (cudaStream_t)stream);
}}

extern "C" int gemm_layout(int* v) {{ return tgemm::layout<{args}>(v); }}
''' + build.ERROR_STRING


_GEMM_LIBS: Dict[Tuple[int, int, int, int], Any] = {}


def _gemm_library(bm: int, bn: int, bk: int, depth: int):
    """The built template at a tile and depth; raises if the library's
    shape is not ``gemm_layout``'s."""
    key = (bm, bn, bk, depth)
    if key in _GEMM_LIBS:
        return _GEMM_LIBS[key]
    lib = build.bind(build.load("tiled_gemm", gemm_source(*key)), {
        "gemm_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p], "gemm_layout": [ctypes.c_void_p]})
    got = (ctypes.c_int * 4)()
    build.check(lib, lib.gemm_layout(ctypes.addressof(got)), "gemm_layout")
    want = gemm_layout(*key)
    if tuple(got) != (want.tm, want.tn, want.threads, want.smem_bytes):
        raise RuntimeError(f"tiled_gemm library at {key} has layout "
                           f"{tuple(got)}, gemm_layout says {want}")
    _GEMM_LIBS[key] = lib
    return lib


def tiled_gemm_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                     bk: int) -> torch.Tensor:
    """Plain PyTorch version of ``tiled_gemm``: the same K-tiled float32
    accumulation, one K tile of the product at a time."""
    out = torch.zeros(x.shape[0], y.shape[1], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], bk):
        out += x[:, k0:k0 + bk] @ y[k0:k0 + bk]
    return out


def tiled_gemm(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
               bk: int, depth: int = 2) -> torch.Tensor:
    """``x @ y`` in float32 through the tiled-GEMM kernel at tile
    ``(bm, bn, bk)`` and metapipeline ``depth``.

    Replaces the TPU kernel ``lower_tiled_gemm`` (reference
    codegen_pallas.py).  Bound by fp32 operations on the card (no TF32:
    parity is held at the f32 tolerance); each block owns one output
    tile and loops over K itself through ``depth`` shared slots filled
    by ``cp.async`` (``gemm_layout``).  CPU tensors take
    ``tiled_gemm_plain``; CUDA tensors launch the kernel or raise.
    """
    m, k = x.shape
    n = y.shape[1]
    _f32("x", x, (m, k))
    _f32("y", y, (k, n))
    if m % bm or n % bn or k % bk:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) must divide ({m}, {n}, {k})")
    if depth < 2:
        raise ValueError(f"metapipeline depth must be >= 2, got {depth}")
    if _on((x, y)).type == "cpu":
        return tiled_gemm_plain(x, y, bm=bm, bn=bn, bk=bk)
    lay = gemm_layout(bm, bn, bk, depth)
    if k % 4 or n % 4 or bk % 4 or bm % lay.tm or bn % lay.tn \
            or lay.threads > 1024:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) on ({m}, {n}, {k}) is "
                         "not one the CUDA template takes")
    optin = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if lay.smem_bytes > optin:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) at depth {depth} needs "
                         f"{lay.smem_bytes} B of shared memory; the card "
                         f"allows {optin} B per block")
    _aligned((("x", x), ("y", y)))
    lib = _gemm_library(bm, bn, bk, depth)
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    rc = lib.gemm_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "tiled_gemm launch")
    tiled_gemm.launches += 1
    return out


tiled_gemm.launches = 0


def lower_tiled_gemm(p: ir.MultiFold, *, depth: int = 2,
                     device=None) -> Callable:
    """GEMM template: the interchanged tiled IR's inner Map{fold} is a
    tile product accumulated over the strided K fold, metapipelined at
    ``depth``.  Returns ``call(**tensors)`` with ``.tile_plan`` (the tile
    sizes the IR carries and the depth) and ``.source`` (the translation
    unit ``gemm_source`` instantiates at them)."""
    assert match_tiled_gemm(p)
    f = p.inner
    loads = [tc for tc in f.loads if isinstance(tc.src, ir.Tensor)]
    assert len(loads) == 2, "gemm expects two tiled operands"
    # operand order from the leaf fold's reads: [0] -> x (bi, bk) indexed
    # (i, k); [1] -> y (bk, bj) indexed (k, j)  (paper Table 3 layout)
    leaf = f.inner.inner
    assert isinstance(leaf, ir.MultiFold) and len(leaf.reads) == 2
    x_tc, y_tc = leaf.reads[0].src, leaf.reads[1].src
    assert x_tc in loads and y_tc in loads
    bi, bj = f.range_shape
    bk = x_tc.tile_shape[1]
    assert x_tc.tile_shape == (bi, bk) and y_tc.tile_shape == (bk, bj)
    dev = resolve(device)

    def call(**tensors):
        x = _staged(tensors[x_tc.src.name], dev)
        y = _staged(tensors[y_tc.src.name], dev)
        return tiled_gemm(x, y, bm=bi, bn=bj, bk=bk, depth=depth)

    call.tile_plan = {p.name: (bi, bj), f.name: (bk,), "depth": depth}
    call.source = gemm_source(bi, bj, bk, depth)
    return call


# --------------------------------------------------------------------
# Fused pipelines: megakernel with on-chip stage intermediates
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Buffer:
    """One shared-memory buffer of the megakernel."""

    label: str       # tensor or stage name (comments, errors)
    kind: str        # "stream" | "hoisted" | "stage" | "cam"
    words: int       # words per slot
    slots: int       # DEPTH for rotating buffers, else 1
    row_words: int   # words per row of the streamed domain
    operand: int = -1   # input operand index (stream / hoisted)


@dataclasses.dataclass(frozen=True)
class Read:
    buffer: int
    whole: bool                  # the whole buffer, else row r of it
    window: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    pattern: ir.Map              # the stage's tile Map (torch + cuda body)
    reads: Tuple[Read, ...]
    out: int                     # its stage buffer


@dataclasses.dataclass(frozen=True)
class Terminal:
    name: str
    kind: str                    # "fold" | "cam" | "map"
    outer: ir.Pattern
    inner: ir.Pattern
    reads: Tuple[Read, ...]
    width: int                   # words per row (fold / map) or per key
    keys: int                    # CAM table rows (1 otherwise)
    shape: Tuple[int, ...]       # output shape
    table: int = -1              # CAM buffer
    partial: int = -1            # offset among a block's partial words
    cam_form: str = ""           # CAM: "register" | "shared" (cam_forms)
    cam_lanes: int = 0           # CAM: column slots P of a warp's 32 lanes
    cam_table: int = -1          # shared form: word offset of the table in
                                 # a warp's staging


DAG_WARPS = 8          # warps of a block: tcopy::THREADS / 32
CAM_REG_WORDS = 64     # a lane's register accumulators over a DAG's CAMs


def _cam_words(keys: int, ew: int, lanes: int) -> int:
    return keys * -(-ew // lanes)


def cam_forms(tables: Sequence[Tuple[int, int]]) -> List[Tuple[str, int]]:
    """The form and column slots ``P`` of each CAM terminal of one DAG,
    from its ``(keys, ew)``: ``(form, P)`` in order.

    A warp's 32 lanes split as P column slots x 32 / P row groups; in the
    register form a lane holds ``keys x ceil(ew / P)`` accumulators.
    Every terminal starts at P = 1 (no exchange between lanes); while
    the register terminals together hold more than CAM_REG_WORDS words a
    lane, the largest of them doubles its P -- or, where that frees no
    register (P = 32, or ew <= P), takes the shared form (P = 32, the
    warp's table in shared memory).  Ties go to the first terminal."""
    lanes = [1] * len(tables)
    forms = ["register"] * len(tables)

    def words(i):
        return _cam_words(*tables[i], lanes[i])

    while True:
        live = [i for i, f in enumerate(forms) if f == "register"]
        if sum(words(i) for i in live) <= CAM_REG_WORDS:
            return list(zip(forms, lanes))
        i = max(live, key=lambda j: (words(j), -j))
        if lanes[i] < 32 and _cam_words(*tables[i], 2 * lanes[i]) < words(i):
            lanes[i] *= 2
        else:
            forms[i], lanes[i] = "shared", 32


def piece_words(lanes: int) -> int:
    """Words of a warp's staging for one piece of P = ``lanes`` columns:
    P rows of 32 + R words (R = 32 / P row groups)."""
    return 0 if lanes == 1 else lanes * (32 + 32 // lanes)


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """What the megakernel of one fused DAG at one plan computes."""

    block: int
    grid: int
    depth: int
    inputs: Tuple[Tuple[str, Tuple[int, ...]], ...]   # operand order
    buffers: Tuple[Buffer, ...]
    stages: Tuple[Stage, ...]
    terminals: Tuple[Terminal, ...]
    partial_words: int
    stage_words: int       # a warp's CAM staging: one piece, then tables
    nearest: Optional["NearestPart"] = None   # a nearest-row stage's DAG

    @property
    def onchip_bytes(self) -> int:
        """The buffers ``memory.plan_memory`` charges; for a nearest-row
        DAG the assignment kernel's ring, norms and keys
        (``memory.NearestLayout.assign_bytes``) with the CAM tables."""
        own = 4 * sum(b.words * b.slots for b in self.buffers)
        if self.nearest is not None:
            own += self.nearest.layout.assign_bytes
        return own

    @property
    def staging_bytes(self) -> int:
        """Shared memory beyond the charge: the CAM terminals' per-warp
        staging and shared-form tables, DAG_WARPS of each."""
        return 4 * DAG_WARPS * self.stage_words

    @property
    def smem_bytes(self) -> int:
        # the epilogue's block reduction reuses the first 32 words
        return max(self.onchip_bytes + self.staging_bytes, 4 * 32)


def _probe(index_map, n_in: int) -> AffineMap:
    if isinstance(index_map, AffineMap):
        return index_map
    return AffineMap.probe(index_map, n_in)


def _additive(p: ir.Pattern) -> bool:
    return p.combine is operator.add


def _zero_identity(p: ir.Pattern) -> bool:
    return not bool(torch.as_tensor(p.init()).any())


def dag_spec(terminals, grid_n: int, depth: int = 2,
             smem_limit: Optional[int] = None) -> DagSpec:
    """Analyse a fused DAG (``pipeline.fuse_dag`` terminals) into the
    megakernel's buffers, stages and terminals, and pick each CAM
    terminal's form (``cam_forms``).  Raises ``NotImplementedError`` for
    shapes the template does not take, and ``ValueError`` when the plan's
    charge fits ``smem_limit`` (a block's shared bytes on the card) but
    the charge plus the CAM staging does not: the form is not changed to
    make room.  A DAG whose stage is a nearest-row one (``ir.Map.nearest``)
    takes ``_nearest_spec``'s kernels."""
    from .fusion import tile_copy_key

    if depth < 2:
        raise ValueError(f"metapipeline depth must be >= 2, got {depth}")
    terminals = tuple(terminals)
    for _, t in terminals:
        if not (t.strided and len(t.domain) == 1 and t.inner is not None):
            raise NotImplementedError("fused DAG: 1-D strided root expected")
        if tuple(t.domain) != (grid_n,):
            raise ValueError(
                f"terminal '{t.name}' grid {t.domain} != ({grid_n},)")
    (block,) = terminals[0][1].inner.domain
    if memory.nearest_dag([t for _, t in terminals]) is not None:
        return _nearest_spec(terminals, grid_n, depth, smem_limit)

    buffers: List[Buffer] = []
    by_uid: Dict[str, int] = {}
    by_key: Dict[Any, int] = {}
    inputs: List[Tuple[str, Tuple[int, ...]]] = []
    stage_tcs: List[ir.TileCopy] = []

    def operand(t: ir.Tensor) -> int:
        for i, (name, _) in enumerate(inputs):
            if name == t.name:
                return i
        if t.dtype != "float32":
            raise NotImplementedError(f"input '{t.name}' is {t.dtype}")
        inputs.append((t.name, tuple(t.shape)))
        return len(inputs) - 1

    # tensor tiles, deduplicated across terminal trees like plan_memory
    for _, t in terminals:
        for tc in t.loads:
            if not isinstance(tc.src, ir.Tensor):
                if tc.uid not in {s.uid for s in stage_tcs}:
                    stage_tcs.append(tc)
                continue
            key = tile_copy_key(tc)
            if key in by_key:
                by_uid[tc.uid] = by_key[key]
                continue
            shape = tuple(tc.src.shape)
            amap = _probe(tc.index_map, 1)
            if any(amap.base):
                raise NotImplementedError(f"tile of '{tc.src.name}' at an offset")
            row_words = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            if tc.hoisted or not any(any(r) for r in amap.mat):
                if tuple(tc.tile_shape) != shape:
                    raise NotImplementedError(
                        f"partial preload of '{tc.src.name}'")
                buf = Buffer(tc.src.name, "hoisted", tc.words, 1, row_words,
                             operand(tc.src))
            else:
                strides = tuple(r[0] for r in amap.mat)
                if tuple(tc.tile_shape) != (block,) + shape[1:] \
                        or strides != (block,) + (0,) * (len(shape) - 1):
                    raise NotImplementedError(
                        f"tile {tc.tile_shape} of '{tc.src.name}' is not a "
                        "block of whole rows")
                if tc.words % 4:
                    raise NotImplementedError(
                        f"tile of '{tc.src.name}' is not a whole number of "
                        "16-byte copies")
                buf = Buffer(tc.src.name, "stream", tc.words, depth,
                             row_words, operand(tc.src))
            buffers.append(buf)
            by_key[key] = by_uid[tc.uid] = len(buffers) - 1

    def reads_of(q: ir.Pattern) -> Tuple[Read, ...]:
        out = []
        for a in q.accesses:
            if not isinstance(a.src, ir.TileCopy) or a.src.uid not in by_uid:
                raise NotImplementedError(
                    f"'{q.name}' reads {a.src!r} outside the staged tiles")
            buf = buffers[by_uid[a.src.uid]]
            tile = tuple(a.src.tile_shape)
            amap = _probe(a.index_map, 2)
            window = tuple(a.window)
            flat = all(not any(r) for r in amap.mat) and not any(amap.base)
            row = (not any(amap.base) and not any(amap.col(0))
                   and amap.col(1) == (1,) + (0,) * (len(tile) - 1)
                   and window == (1,) + tile[1:])
            if flat and window == tile:
                out.append(Read(by_uid[a.src.uid], True, window))
            elif row and buf.kind != "hoisted":
                out.append(Read(by_uid[a.src.uid], False, window))
            else:
                raise NotImplementedError(
                    f"'{q.name}' reads a window {window} of {buf.label} "
                    "that is neither its row nor the whole tile")
        return tuple(out)

    # stage buffers, in first-appearance (topological) order
    stages: List[Stage] = []
    for tc in stage_tcs:
        s = tc.src
        if not isinstance(s, ir.Map) or s.inner is not None or s.loads:
            raise NotImplementedError(f"stage '{tc.name}' is not a flat Map")
        if s.cuda is None:
            raise NotImplementedError(f"stage '{s.name}' has no CUDA body")
        es = int(np.prod(s.elem_shape)) if s.elem_shape else 1
        reads = reads_of(s)
        buffers.append(Buffer(tc.name, "stage", block * es, depth, es))
        by_uid[tc.uid] = len(buffers) - 1
        stages.append(Stage(tc.name, s, reads, len(buffers) - 1))

    terms: List[Terminal] = []
    partial = 0
    for name, p in terminals:
        q = p.inner
        if q.cuda is None:
            raise NotImplementedError(f"terminal '{q.name}' has no CUDA body")
        if isinstance(p, ir.MultiFold) and p.combine is None:
            if not isinstance(q, ir.Map) or q.inner is not None:
                raise NotImplementedError("write-once terminal must wrap a Map")
            w = int(np.prod(q.elem_shape)) if q.elem_shape else 1
            terms.append(Terminal(name, "map", p, q, reads_of(q), w, 1,
                                  tuple(p.range_shape)))
        elif isinstance(p, ir.MultiFold):
            if not (isinstance(q, ir.MultiFold) and q.is_fold
                    and q.inner is None):
                raise NotImplementedError(
                    f"fold terminal '{name}' must fold a whole accumulator")
            if not (_additive(p) and _additive(q) and _zero_identity(q)):
                raise NotImplementedError(
                    f"fold terminal '{name}': the template combines by +")
            w = int(np.prod(p.range_shape)) if p.range_shape else 1
            terms.append(Terminal(name, "fold", p, q, reads_of(q), w, 1,
                                  tuple(p.range_shape), partial=partial))
            partial += w
        elif isinstance(p, ir.GroupByFold):
            if not isinstance(q, ir.GroupByFold) or q.inner is not None:
                raise NotImplementedError(
                    f"keyed terminal '{name}' must wrap a keyed fold")
            if not (_additive(p) and _additive(q)):
                raise NotImplementedError(
                    f"keyed terminal '{name}': the template combines by +")
            ew = int(np.prod(p.elem_shape)) if p.elem_shape else 1
            buffers.append(Buffer(q.name, "cam", p.num_keys * ew, 1, ew))
            terms.append(Terminal(name, "cam", p, q, reads_of(q), ew,
                                  p.num_keys, tuple(p.shape),
                                  table=len(buffers) - 1, partial=partial))
            partial += p.num_keys * ew
        else:
            raise NotImplementedError(
                f"no fused template for terminal {type(p).__name__}")

    # CAM forms; a warp's staging holds the largest piece, then the
    # shared-form tables
    cams = [i for i, t in enumerate(terms) if t.kind == "cam"]
    forms = cam_forms([(terms[i].keys, terms[i].width) for i in cams])
    stage_words = max([piece_words(lanes) for _, lanes in forms] + [0])
    for i, (form, lanes) in zip(cams, forms):
        table = -1
        if form == "shared":
            table, stage_words = stage_words, \
                stage_words + terms[i].keys * terms[i].width
        terms[i] = dataclasses.replace(terms[i], cam_form=form,
                                       cam_lanes=lanes, cam_table=table)

    # streamed tiles first (16-byte aligned), then stages, preloads, CAMs
    order = {"stream": 0, "stage": 1, "hoisted": 2, "cam": 3}
    perm = sorted(range(len(buffers)), key=lambda i: (order[buffers[i].kind], i))
    remap = {old: new for new, old in enumerate(perm)}

    def fix(reads):
        return tuple(dataclasses.replace(r, buffer=remap[r.buffer])
                     for r in reads)

    spec = DagSpec(
        block=int(block), grid=int(grid_n), depth=int(depth),
        inputs=tuple(inputs),
        buffers=tuple(buffers[i] for i in perm),
        stages=tuple(dataclasses.replace(s, reads=fix(s.reads),
                                         out=remap[s.out]) for s in stages),
        terminals=tuple(dataclasses.replace(
            t, reads=fix(t.reads),
            table=remap[t.table] if t.table >= 0 else -1) for t in terms),
        partial_words=partial, stage_words=stage_words)
    if smem_limit is not None \
            and spec.onchip_bytes <= smem_limit < spec.smem_bytes:
        raise ValueError(
            f"fused DAG ({', '.join(t.name for t in spec.terminals)}): the "
            f"plan charges {spec.onchip_bytes} B and its CAM staging needs "
            f"{spec.staging_bytes} B more; a block may use {smem_limit} B")
    return spec


# ------------------------------------------------------ source emission


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _body_fn(fname: str, n_reads: int, body: str, keyed: bool = False,
             counted: bool = False) -> str:
    params = [f"const float* __restrict__ in{j}" for j in range(n_reads)]
    params.append("float* __restrict__ out")
    if keyed:
        params.append("int& key")
    if counted:
        params.append("int& count")
    text = "\n".join("  " + line for line in body.strip().splitlines())
    return (f"__device__ __forceinline__ void {fname}(\n    "
            + ",\n    ".join(params) + ") {\n" + text + "\n}\n")


def _cam_acc(t: Terminal, j: int, p: int) -> str:
    """The register accumulator of key ``j``, piece ``p`` of a CAM
    terminal: one scalar each, so no accumulator is ever indexed."""
    return f"cam_{_ident(t.name)}_{j}_{p}"


def cam_row_c(acc: Callable[[int, int], str], keys: int, ew: int,
              lanes: int, shared: str = "",
              value: Callable[[int], str] = "v[{}]".format) -> List[str]:
    """The adds of one row per lane into a CAM table without atomics
    (fused_dag.cuh: register and shared forms), for the lane's row
    values ``value(c)`` and its ``key``, with ``lane`` and, for P > 1,
    the warp's staging ``stage_w`` in scope.  The register form adds
    onto the named scalars ``acc(j, p)`` (key j, piece p), one line per
    (row, key): ptxas keeps an accumulator array in local memory even
    where unrolling leaves only constant indices.  The shared form
    (``shared``: the warp's table) adds into its own key's cells.  Shared
    by the fused DAG's CAM terminals and the hand-written keyed kernels
    (``kernels.fused_kmeans``, ``kernels.groupby_fold``)."""
    L: List[str] = []
    if lanes == 1:   # each lane adds its own row
        for j in range(keys):
            adds = " ".join(f"{acc(j, c)} += {value(c)};" for c in range(ew))
            L.append(f"      if (key == {j}) {{ {adds} }}")
        return L
    groups, nc = 32 // lanes, -(-ew // lanes)
    stride = 32 + groups
    L.append(f"      const int cs = lane % {lanes}, grp = lane / {lanes};")
    L += [f"      const int kr{i} = __shfl_sync(0xffffffffu, key, grp + "
          f"{groups * i});  // key of row grp + {groups * i}"
          for i in range(lanes)]
    for p in range(nc):
        cols = min(lanes, ew - p * lanes)
        L.append(f"      {{  // piece {p}: columns {p * lanes} .. "
                 f"{p * lanes + cols - 1}")
        L += [f"      stage_w[{c * stride} + lane] = {value(p * lanes + c)};"
              for c in range(cols)]
        L.append("      __syncwarp();")
        L.append(f"      const float* const col = stage_w + cs * {stride} "
                 "+ grp;")
        ind = "      "
        if cols < lanes:
            L.append(f"      if (cs < {cols}) {{")
            ind = "        "
        for i in range(lanes):
            x = f"col[{groups * i}]"
            if not shared:
                adds = " ".join(f"if (kr{i} == {j}) {acc(j, p)} += x;"
                                for j in range(keys))
                L.append(f"{ind}{{ const float x = {x}; {adds} }}")
            else:
                L.append(f"{ind}if ((unsigned)kr{i} < {keys}u) "
                         f"{shared}[kr{i} * {ew} + "
                         f"{p * lanes} + lane] += {x};")
        if cols < lanes:
            L.append("      }")
        L.append("      __syncwarp();")
        L.append("      }")
    return L


def cam_groups_c(acc: Callable[[int, int], str], keys: int, ew: int,
                 lanes: int) -> List[str]:
    """A register form's row groups added by a fixed shuffle tree: lanes
    below P then hold the warp's sums."""
    nc = -(-ew // lanes)
    L: List[str] = []
    o = 16
    while o >= lanes:
        L += [f"  {acc(j, p)} += __shfl_down_sync(0xffffffffu, "
              f"{acc(j, p)}, {o});" for j in range(keys) for p in range(nc)]
        o //= 2
    return L


def cam_turn_c(acc: Callable[[int, int], str], keys: int, ew: int,
               lanes: int, table: str) -> List[str]:
    """A register form's warp adding its sums (after ``cam_groups_c``)
    into the block's shared ``table`` on its turn."""
    nc = -(-ew // lanes)
    L = [f"      if (lane < {lanes}) {{"]
    for p in range(nc):
        cols = min(lanes, ew - p * lanes)
        guard = f"if (lane < {cols}) " if cols < lanes else ""
        L += [f"        {guard}{table}[{j * ew + p * lanes} + lane]"
              f" += {acc(j, p)};" for j in range(keys)]
    L.append("      }")
    return L


def cam_struct_c(tables: Sequence[Tuple[str, int, int, int,
                                        Callable[[int], str]]],
                 row_words: int) -> str:
    """``struct Cam`` of a hand-written keyed kernel (fused_kmeans.cuh,
    groupby_fold.cuh): the register form of fused_dag.cuh's CAM for each
    table ``(name, keys, ew, lanes, value)``.  It holds the lane's
    accumulators as named scalars ``<name>_<key>_<piece>``;
    ``add(v, key, lane, stage_w)`` adds the lane's row (``v`` of
    ``row_words`` values, each table's values ``value(c)``) by
    ``cam_row_c``, every lane of the warp together; ``finish(t_<name>,
    ..., warp, lane)`` adds the row groups by a fixed shuffle tree and
    then the warps into each block table ``t_<name>`` in warp order, a
    ``__syncthreads`` before each turn.  ``STAGE_WORDS`` is a warp's
    staging."""
    def acc(name):
        return lambda j, p: f"{name}_{j}_{p}"

    stage = max(piece_words(lanes) for _, _, _, lanes, _ in tables)
    L = ["struct Cam {", f"  static constexpr int STAGE_WORDS = {stage};"]
    for name, k, ew, lanes, _ in tables:
        L += ["  float " + ", ".join(f"{acc(name)(j, p)} = 0.0f"
                                   for p in range(-(-ew // lanes))) + ";"
              for j in range(k)]
    L.append(f"  __device__ __forceinline__ void add(const float (&v)"
             f"[{row_words}], int key, int lane, float* stage_w) {{")
    for name, k, ew, lanes, value in tables:
        L += ["    {"] + cam_row_c(acc(name), k, ew, lanes,
                                   value=value) + ["    }"]
    L.append("  }")
    params = ", ".join(f"float* t_{name}" for name, *_ in tables)
    L.append(f"  __device__ __forceinline__ void finish({params}, int warp, "
             "int lane) {")
    turn: List[str] = []
    for name, k, ew, lanes, _ in tables:
        L += cam_groups_c(acc(name), k, ew, lanes)
        turn += cam_turn_c(acc(name), k, ew, lanes, f"t_{name}")
    L += ["  for (int w = 0; w < tcopy::THREADS / 32; ++w) {",
          "    __syncthreads();", "    if (warp == w) {"] + turn + \
        ["    }", "  }", "  }", "};"]
    return "\n".join(L)


def _cam_step_c(spec: DagSpec, t: Terminal, args: List[str]) -> List[str]:
    """One CAM terminal in the step loop: each warp runs the body on its
    32 rows, and every row's values reach the lanes that own their
    columns (``cam_row_c``)."""
    k, ew, lanes = t.keys, t.width, t.cam_lanes
    groups = 32 // lanes
    call = f"body_{_ident(t.name)}({', '.join(args + ['v', 'key'])});"
    L = [f"    // terminal {t.name} (cam, {t.cam_form} form: {lanes} column "
         f"slots x {groups} row groups)",
         "    for (int r0 = warp * 32; r0 < BLOCK; r0 += blockDim.x) {",
         "      const int r = r0 + lane;",
         "      int key = -1;"]
    if spec.block % 32:
        L += [f"      float v[{ew}] = {{}};", f"      if (r < BLOCK) {call}"]
    else:
        L += [f"      float v[{ew}];", f"      {call}"]
    shared = f"wt_{_ident(t.name)}" if t.cam_form == "shared" else ""
    L += cam_row_c(functools.partial(_cam_acc, t), k, ew, lanes, shared)
    L.append("    }")
    return L


def _cam_end_c(spec: DagSpec) -> List[str]:
    """After the walk: each register form's row groups added by a fixed
    shuffle tree, then the warps' tables added into the block's shared
    table in warp order."""
    cams = [t for t in spec.terminals if t.kind == "cam"]
    if not cams:
        return []
    L = ["  // CAM terminals: row groups by a fixed shuffle tree, then the "
         "warps' tables into the block's table in warp order"]
    turn: List[str] = []
    for t in cams:
        k, ew, lanes = t.keys, t.width, t.cam_lanes
        if t.cam_form == "shared":
            turn += [f"      for (int e = lane; e < {k * ew}; e += 32) "
                     f"buf{t.table}[e] += wt_{_ident(t.name)}[e];"]
            continue
        acc = functools.partial(_cam_acc, t)
        L += cam_groups_c(acc, k, ew, lanes)
        turn += cam_turn_c(acc, k, ew, lanes, f"buf{t.table}")
    L += ["  for (int w = 0; w < WARPS; ++w) {", "    __syncthreads();",
          "    if (warp == w) {"] + turn + ["    }", "  }"]
    return L


def _accumulators_c(terms: Sequence[Terminal]) -> List[str]:
    """A block's accumulators: each fold terminal's array, each register
    CAM's named scalars, each shared CAM's zeroed warp table."""
    L: List[str] = []
    for t in terms:
        if t.kind == "fold":
            L.append(f"  float acc_{_ident(t.name)}[{t.width}] = {{}};")
        elif t.kind == "cam" and t.cam_form == "register":
            nc = -(-t.width // t.cam_lanes)
            L += ["  float " + ", ".join(f"{_cam_acc(t, j, p)} = 0.0f"
                                         for p in range(nc)) + ";"
                  for j in range(t.keys)]
        elif t.kind == "cam":
            wt = f"wt_{_ident(t.name)}"
            L.append(f"  float* const {wt} = stage_w + {t.cam_table};")
            L.append(f"  for (int e = lane; e < {t.keys * t.width}; e += 32) "
                     f"{wt}[e] = 0.0f;")
    return L


def _partials_c(spec: DagSpec) -> List[str]:
    """After the walk: the CAM tables into the block's (``_cam_end_c``),
    then the block's partial of every CAM and fold terminal."""
    L = _cam_end_c(spec)
    L.append("  __syncthreads();")
    L.append("  float* const part = partials + (long long)blockIdx.x "
             "* PARTIAL_WORDS;")
    for t in spec.terminals:
        if t.kind == "cam":
            L.append(f"  for (int e = threadIdx.x; e < {t.keys * t.width}; "
                     f"e += blockDim.x) part[{t.partial} + e] = "
                     f"buf{t.table}[e];")
    L.append("  __syncthreads();  // shared memory becomes reduction scratch")
    for t in spec.terminals:
        if t.kind == "fold":
            L.append(f"  for (int j = 0; j < {t.width}; ++j) {{")
            L.append(f"    const float s = fdag::block_sum("
                     f"acc_{_ident(t.name)}[j], smem);")
            L.append(f"    if (threadIdx.x == 0) part[{t.partial} + j] = s;")
            L.append("  }")
    return L


def _ring_c(fill: Callable[[str, str, str], List[str]]
            ) -> Tuple[List[str], List[str]]:
    """The lines of the ``cp.async`` ring over grid steps (``fused_dag.cuh``
    sets out why it is safe): before the step loop, the first ``DEPTH -
    1`` steps in flight; at the top of step ``g`` (after ``slot`` and
    ``step`` are bound), wait for this thread's copies of the step, one
    ``__syncthreads``, then refill the slot step - 1 read with step ``g +
    (DEPTH - 1) * gridDim.x``.  ``fill(indent, slot, g)`` gives the lines
    that issue one step's copies; every step commits a group, empty or
    not, so the wait count holds to the end."""
    prologue = ["  // the ring: the first DEPTH - 1 steps in flight",
                "#pragma unroll",
                "  for (int s = 0; s < DEPTH - 1; ++s) {",
                "    const long long gs = blockIdx.x + (long long)s * "
                "gridDim.x;",
                "    if (gs < GRID) {",
                *fill("      ", "s", "gs"),
                "    }",
                "    hop::cp_async_commit();",
                "  }"]
    top = ["    hop::cp_async_wait<DEPTH - 2>();  // this thread's copies "
           "of step",
           "    __syncthreads();  // everyone's landed; step - 1's slot is "
           "free",
           "    const long long ga = g + (long long)(DEPTH - 1) * gridDim.x;",
           "    if (ga < GRID) {",
           *fill("      ", "(step + DEPTH - 1) % DEPTH", "ga"),
           "    }",
           "    hop::cp_async_commit();"]
    return prologue, top


def dag_source(spec: DagSpec) -> str:
    """The translation unit of one fused DAG at one plan: the template
    ``fused_dag.cuh`` instantiated with the pattern bodies, the plan's
    constants and each CAM terminal's form.  Streamed tiles go through
    the ``DEPTH``-slot ``cp.async`` ring; CAM terminals add without
    atomics in a fixed order.  Deterministic for a given DAG and plan."""
    b, depth = spec.block, spec.depth
    offsets, off = [], 0
    for buf in spec.buffers:
        offsets.append(off)
        off += buf.words * buf.slots
    names = ", ".join(t.name for t in spec.terminals)
    L: List[str] = [
        f"// fused DAG megakernel ({names}) at block {b}, depth {depth};",
        "// generated by codegen_cuda from fused_dag.cuh",
        '#include "fused_dag.cuh"', "",
        "namespace {",
        f"constexpr int BLOCK = {b};",
        f"constexpr int DEPTH = {depth};",
        f"constexpr long long GRID = {spec.grid}LL;",
        f"constexpr int WARPS = {DAG_WARPS};",
        f"constexpr int SMEM_BYTES = {spec.smem_bytes};",
        f"constexpr int PARTIAL_WORDS = {spec.partial_words};",
        'static_assert(tcopy::THREADS == 32 * WARPS, '
        '"codegen_cuda.DAG_WARPS");', ""]
    for s in spec.stages:
        L.append(_body_fn(f"body_{_ident(s.name)}", len(s.reads),
                          s.pattern.cuda, False))
    for t in spec.terminals:
        L.append(_body_fn(f"body_{_ident(t.name)}", len(t.reads),
                          t.inner.cuda, t.kind == "cam"))

    n_map = sum(t.kind == "map" for t in spec.terminals)
    params = [f"const float* __restrict__ in_{_ident(n)}"
              for n, _ in spec.inputs]
    params += [f"float* __restrict__ out_{_ident(t.name)}"
               for t in spec.terminals if t.kind == "map"]
    params.append("float* __restrict__ partials")
    L.append("__global__ void __launch_bounds__(tcopy::THREADS)\n"
             "fused_dag_kernel(" + ", ".join(params) + ") {")
    L.append("  extern __shared__ float4 smem4[];")
    L.append("  float* const smem = reinterpret_cast<float*>(smem4);")
    L.append("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;")
    for i, (buf, o) in enumerate(zip(spec.buffers, offsets)):
        L.append(f"  float* const buf{i} = smem + {o};  // {buf.kind} "
                 f"{buf.label}: {buf.slots} x {buf.words} words")
    if spec.stage_words:
        L.append(f"  float* const stage_w = smem + {off} + warp * "
                 f"{spec.stage_words};  // this warp's CAM staging")
    # per-block set-up: preloads, zeroed CAM tables, CAM accumulators
    for i, buf in enumerate(spec.buffers):
        if buf.kind == "hoisted":
            src = f"in_{_ident(spec.inputs[buf.operand][0])}"
            L.append(f"  tcopy::copy_scalar(buf{i}, {src}, {buf.words});")
        elif buf.kind == "cam":
            L.append(f"  fdag::zero(buf{i}, {buf.words});")
    L += _accumulators_c(spec.terminals)
    L.append("  __syncthreads();")

    streams = [(i, buf) for i, buf in enumerate(spec.buffers)
               if buf.kind == "stream"]

    def fill(indent: str, slot: str, g: str) -> List[str]:
        return [f"{indent}fdag::copy_async(buf{i} + ({slot}) * {buf.words}, "
                f"in_{_ident(spec.inputs[buf.operand][0])} + ({g}) * "
                f"{buf.words}LL, {buf.words});" for i, buf in streams]

    prologue, top = _ring_c(fill)
    L += prologue
    L.append("  int step = 0;")
    L.append("  for (long long g = blockIdx.x; g < GRID; "
             "g += gridDim.x, ++step) {")
    L.append("    const int slot = step % DEPTH;")
    L += top
    for i, buf in enumerate(spec.buffers):
        if buf.kind in ("stream", "stage"):
            L.append(f"    float* const s{i} = buf{i} + slot * {buf.words};")

    def args(reads: Tuple[Read, ...]) -> List[str]:
        out = []
        for r in reads:
            buf = spec.buffers[r.buffer]
            base = f"buf{r.buffer}" if buf.kind in ("hoisted", "cam") \
                else f"s{r.buffer}"
            out.append(base if r.whole else f"{base} + r * {buf.row_words}")
        return out

    row_loop = "    for (int r = threadIdx.x; r < BLOCK; r += blockDim.x)"
    for s in spec.stages:
        out_buf = spec.buffers[s.out]
        a = args(s.reads) + [f"s{s.out} + r * {out_buf.row_words}"]
        L.append(f"    // stage {s.name}")
        L.append(row_loop)
        L.append(f"      body_{_ident(s.name)}({', '.join(a)});")
        L.append("    __syncthreads();")
    for t in spec.terminals:
        if t.kind == "cam":
            L += _cam_step_c(spec, t, args(t.reads))
            continue
        fn = f"body_{_ident(t.name)}"
        L.append(f"    // terminal {t.name} ({t.kind})")
        L.append(row_loop + " {")
        if t.kind == "fold":
            L.append(f"      float v[{t.width}];")
            L.append(f"      {fn}({', '.join(args(t.reads) + ['v'])});")
            L.append(f"      for (int j = 0; j < {t.width}; ++j) "
                     f"acc_{_ident(t.name)}[j] += v[j];")
        else:
            dst = f"out_{_ident(t.name)} + (g * BLOCK + r) * {t.width}LL"
            L.append(f"      {fn}({', '.join(args(t.reads) + [dst])});")
        L.append("    }")
    L.append("  }")
    L.append("  hop::cp_async_wait<0>();")
    # epilogue: one partial per block for every fold and CAM terminal
    L += _partials_c(spec)
    L.append("}")
    L.append("}  // namespace")
    L.append("")
    n_in = len(spec.inputs)
    call = [f"(const float*)ins[{i}]" for i in range(n_in)]
    call += [f"(float*)outs[{i}]" for i in range(n_map)]
    call.append("(float*)partials")
    L.append(_ctas_source("fdag", "fused_dag_kernel", "SMEM_BYTES"))
    # start / end: CUDA timing events recorded right around the launch
    # (telemetry.device_span's pair), or null
    L.append(f'''static int launch_dag(void* const* ins, void* const* outs,
                      void* partials, int ctas, cudaStream_t stream) {{
  fused_dag_kernel<<<ctas, tcopy::THREADS, SMEM_BYTES, stream>>>(
      {", ".join(call)});
  return (int)cudaGetLastError();
}}

extern "C" int fdag_launch(void* const* ins, void* const* outs,
                           void* partials, int ctas, void* stream,
                           void* start, void* end) {{
  int rc = fdag::record(start, (cudaStream_t)stream);
  if (rc) return rc;
  rc = launch_dag(ins, outs, partials, ctas, (cudaStream_t)stream);
  return rc ? rc : fdag::record(end, (cudaStream_t)stream);
}}

extern "C" int fdag_combine(const void* partials, const void* init,
                            void* out, int ctas, void* stream,
                            void* start, void* end) {{
  if (PARTIAL_WORDS == 0) return 0;
  int rc = fdag::record(start, (cudaStream_t)stream);
  if (rc) return rc;
  fdag::combine_partials<<<(PARTIAL_WORDS + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(
      (const float*)partials, (const float*)init, (float*)out, ctas,
      PARTIAL_WORDS);
  rc = (int)cudaGetLastError();
  return rc ? rc : fdag::record(end, (cudaStream_t)stream);
}}

// The megakernel and its combine, launched as fdag_launch and
// fdag_combine launch them, captured on a stream of its own into one
// CUDA graph: *exec is its executable graph, which fdag_graph_launch
// replays on any stream of the card and fdag_graph_free destroys.
extern "C" int fdag_graph(void* const* ins, void* const* outs,
                          void* partials, const void* init, void* out,
                          int ctas, void** exec) {{
  cudaStream_t s;
  cudaGraph_t graph = nullptr;
  int rc = (int)cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (rc) return rc;
  rc = (int)cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (!rc) {{
    int lrc = launch_dag(ins, outs, partials, ctas, s);
    if (!lrc)
      lrc = fdag::launch_combine((const float*)partials, (const float*)init,
                                 (float*)out, ctas, PARTIAL_WORDS, s);
    rc = (int)cudaStreamEndCapture(s, &graph);
    if (!rc) rc = lrc;
  }}
  if (!rc)
    rc = (int)cudaGraphInstantiateWithFlags((cudaGraphExec_t*)exec, graph, 0);
  if (graph) cudaGraphDestroy(graph);
  cudaStreamDestroy(s);
  return rc;
}}

extern "C" int fdag_graph_launch(void* exec, void* stream) {{
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}}

extern "C" int fdag_graph_free(void* exec) {{
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}}''')
    return "\n".join(L) + build.ERROR_STRING


# --------------------------------------------------------------------
# Nearest-row DAGs: a stage that is an argmin over a table's rows, the
# table streamed in tiles, and a keyed sum of rows folded a column
# slice at a time (csrc/nearest_dag.cuh)
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NearestPart:
    """What a nearest-row DAG adds to its ``DagSpec``: the layout, the
    stage, its table and query operands, and the keyed sum of rows the
    fold kernel takes (``fold``: its terminal's index, or -1)."""

    layout: "memory.NearestLayout"
    stage: str          # the nearest-row stage's name
    table: int          # operand index of the K x D table
    query: int          # operand index of the n x D query rows
    fold: int           # terminal folded by column slices, or -1
    values: int         # operand index of the fold's rows
    partial1: int       # words of an assignment block's partial

    @property
    def fold_words(self) -> int:
        lay = self.layout
        return lay.keys * lay.dim if self.fold >= 0 else 0


def scratch_words(spec: DagSpec, ctas: int) -> int:
    """Words of the device scratch one launch of ``spec`` takes: the
    blocks' partials; for a nearest-row DAG with a fold, then the fold's
    chunk partials and the keys (each 16-byte aligned)."""
    near = spec.nearest
    if near is None:
        return max(spec.partial_words, 1) * ctas
    words = -(-max(near.partial1, 1) * ctas // 4) * 4
    if near.fold >= 0:
        words += memory.FOLD_CHUNKS * near.fold_words \
            + -(-spec.grid * spec.block // 4) * 4
    return words


def _tensor_of(a: ir.Access) -> Optional[ir.Tensor]:
    src = a.src
    if isinstance(src, ir.TileCopy):
        src = src.src
    return src if isinstance(src, ir.Tensor) else None


def _nearest_spec(terminals, grid_n: int, depth: int,
                  smem_limit: Optional[int]) -> DagSpec:
    """The ``DagSpec`` of a DAG whose one stage is a nearest-row Map: its
    table is read in tiles of rows by the assignment kernel, so nothing
    of it is staged whole; the other terminals read only the stage, or
    are one keyed sum of rows (``ir.GroupByFold.keyed_rows``), which
    the fold kernel takes by column slices.  Raises
    ``NotImplementedError`` for any other shape, and where no layout
    fits ``smem_limit`` (``memory.nearest_layout``)."""
    (block,) = terminals[0][1].inner.domain
    stage_tc = None
    for _, t in terminals:
        for tc in t.loads:
            if isinstance(tc.src, ir.Tensor):
                continue
            if stage_tc is not None and tc.uid != stage_tc.uid:
                raise NotImplementedError(
                    "nearest-row DAG: one stage, the nearest-row one")
            stage_tc = tc
    s = stage_tc.src
    if s.nearest is None or s.elem_shape:
        raise NotImplementedError(
            f"stage '{s.name}' is not a scalar nearest-row Map")
    inputs: List[Tuple[str, Tuple[int, ...]]] = []

    def operand(t: ir.Tensor) -> int:
        for i, (name, _) in enumerate(inputs):
            if name == t.name:
                return i
        if t.dtype != "float32":
            raise NotImplementedError(f"input '{t.name}' is {t.dtype}")
        inputs.append((t.name, tuple(t.shape)))
        return len(inputs) - 1

    ta, qa = (s.reads[i] for i in s.nearest)
    table, query = _tensor_of(ta), _tensor_of(qa)
    if table is None or query is None or len(table.shape) != 2 \
            or tuple(ta.window) != tuple(table.shape) \
            or len(query.shape) != 2 or query.shape[1] != table.shape[1] \
            or tuple(qa.window) != (1, query.shape[1]):
        raise NotImplementedError(
            f"stage '{s.name}': a whole K x D table and a D-row of the "
            "query rows expected")
    keys, dim = (int(e) for e in table.shape)
    t_op, q_op = operand(table), operand(query)

    def stage_read(a: ir.Access) -> bool:
        return isinstance(a.src, ir.TileCopy) and a.src.uid == stage_tc.uid

    # the stage's keys live in the assignment kernel's charge
    # (``memory.NearestLayout.assign_bytes``): its reads name no buffer
    buffers: List[Buffer] = []
    terms: List[Terminal] = []
    partial, fold, values = 0, -1, -1
    for name, p in terminals:
        q = p.inner
        if isinstance(p, ir.GroupByFold) and q.keyed_rows is not None:
            ka, va = (q.reads[i] for i in q.keyed_rows)
            vt = _tensor_of(va)
            ew = int(np.prod(p.elem_shape)) if p.elem_shape else 1
            if fold >= 0 or not stage_read(ka) or vt is None \
                    or len(vt.shape) != 2 or int(vt.shape[1]) != dim \
                    or ew != dim or tuple(va.window) != (1, dim) \
                    or p.num_keys != keys or not _additive(p):
                raise NotImplementedError(
                    f"keyed sum of rows '{name}': one, keyed by the "
                    f"stage, of D = {dim}-rows, over the table's keys")
            values = operand(vt)
            fold = len(terms)
            terms.append(Terminal(name, "cam", p, q, (), ew, p.num_keys,
                                  tuple(p.shape), cam_form="sliced"))
            continue
        if not all(stage_read(a) for a in q.accesses):
            raise NotImplementedError(
                f"terminal '{name}' of a nearest-row DAG reads more than "
                "the stage")
        reads = tuple(Read(-1, False, (1,)) for _ in q.accesses)
        if q.cuda is None:
            raise NotImplementedError(f"terminal '{q.name}' has no CUDA body")
        if isinstance(p, ir.GroupByFold) and isinstance(q, ir.GroupByFold) \
                and _additive(p) and _additive(q):
            ew = int(np.prod(p.elem_shape)) if p.elem_shape else 1
            buffers.append(Buffer(q.name, "cam", p.num_keys * ew, 1, ew))
            terms.append(Terminal(name, "cam", p, q, reads, ew, p.num_keys,
                                  tuple(p.shape), table=len(buffers) - 1,
                                  partial=partial))
            partial += p.num_keys * ew
        elif isinstance(p, ir.MultiFold) and p.combine is not None \
                and isinstance(q, ir.MultiFold) and q.is_fold \
                and q.inner is None and _additive(p) and _additive(q) \
                and _zero_identity(q):
            w = int(np.prod(p.range_shape)) if p.range_shape else 1
            terms.append(Terminal(name, "fold", p, q, reads, w, 1,
                                  tuple(p.range_shape), partial=partial))
            partial += w
        else:
            raise NotImplementedError(
                f"no nearest-row DAG template for terminal '{name}'")
    partial1 = partial
    if fold >= 0:   # the fold's table comes last in the combine's output
        terms[fold] = dataclasses.replace(terms[fold], partial=partial)
        partial += keys * dim
    cams = [i for i, t in enumerate(terms)
            if t.kind == "cam" and t.cam_form != "sliced"]
    forms = cam_forms([(terms[i].keys, terms[i].width) for i in cams])
    stage_words = max([piece_words(lanes) for _, lanes in forms] + [0])
    for i, (form, lanes) in zip(cams, forms):
        table_at = -1
        if form == "shared":
            table_at, stage_words = stage_words, \
                stage_words + terms[i].keys * terms[i].width
        terms[i] = dataclasses.replace(terms[i], cam_form=form,
                                       cam_lanes=lanes, cam_table=table_at)
    budget = smem_limit if smem_limit is not None \
        else DEFAULT_TIER.onchip_bytes
    lay = memory.nearest_layout(block, depth, keys, dim, fold >= 0, budget)
    if lay is None:
        raise NotImplementedError(
            f"nearest-row stage '{s.name}' ({keys} x {dim} table) at block "
            f"{block}, depth {depth}: no tile layout fits {budget} B")
    spec = DagSpec(
        block=int(block), grid=int(grid_n), depth=int(depth),
        inputs=tuple(inputs), buffers=tuple(buffers), stages=(),
        terminals=tuple(terms), partial_words=partial,
        stage_words=stage_words,
        nearest=NearestPart(lay, stage_tc.name, t_op, q_op, fold, values,
                            partial1))
    if smem_limit is not None and spec.smem_bytes > smem_limit:
        raise ValueError(
            f"nearest-row DAG ({', '.join(t.name for t in terms)}): the "
            f"assignment kernel needs {spec.smem_bytes} B; a block may use "
            f"{smem_limit} B")
    return spec


def nearest_source(spec: DagSpec) -> str:
    """The translation unit of a nearest-row DAG at one plan:
    ``nearest_dag.cuh``'s assignment kernel with the DAG's other
    terminals in its epilogue, its fold kernel for the keyed sum of rows,
    and the entry points ``fdag_*`` as ``dag_source`` names them, plus
    ``fdag_fold``.  Deterministic for a given DAG and plan."""
    near = spec.nearest
    lay = near.layout
    names = ", ".join(t.name for t in spec.terminals)
    others = [t for t in spec.terminals if t.cam_form != "sliced"]
    tables, off = [], 0
    for t in others:
        if t.kind == "cam":
            tables.append((t, off))
            off += t.keys * t.width
    L: List[str] = [
        f"// nearest-row DAG ({names}) at block {spec.block}, depth "
        f"{spec.depth}, tile {lay.tile}, fold columns {lay.fold_cols};",
        "// generated by codegen_cuda from nearest_dag.cuh",
        '#include "nearest_dag.cuh"', "",
        "namespace {",
        f"constexpr int BLOCK = {spec.block};",
        f"constexpr int DEPTH = {spec.depth};",
        f"constexpr long long GRID = {spec.grid}LL;",
        f"constexpr long long ROWS = {spec.grid * spec.block}LL;",
        f"constexpr int WARPS = {DAG_WARPS};",
        f"using A = ndag::Assign<BLOCK, {lay.tile}, {lay.tm}, {lay.tn}, "
        f"DEPTH, {lay.keys}, {lay.dim}, {lay.slab}, {lay.pad}>;",
        f"using F = ndag::Fold<{lay.keys}, {lay.dim}, "
        f"{max(lay.fold_cols, 32)}, {max(lay.fold_depth, 2)}, "
        f"{memory.FOLD_CHUNKS}>;",
        f"constexpr bool FOLD = {'true' if near.fold >= 0 else 'false'};",
        f"constexpr int CAM_WORDS = {off};",
        f"constexpr int STAGE_WORDS = {spec.stage_words};",
        "constexpr int SMEM_BYTES = 4 * (A::WORDS + CAM_WORDS + WARPS * "
        "STAGE_WORDS);",
        f"constexpr int FOLD_BYTES = 4 * F::WORDS;",
        f"constexpr int PARTIAL_WORDS = {near.partial1};",
        f"constexpr long long FOLD_WORDS = {near.fold_words}LL;",
        f"static_assert(SMEM_BYTES == {spec.smem_bytes}, "
        '"codegen_cuda.DagSpec.smem_bytes");',
        'static_assert(tcopy::THREADS == 32 * WARPS && ndag::THREADS == '
        'tcopy::THREADS, "codegen_cuda.DAG_WARPS");', ""]
    for t in others:
        L.append(_body_fn(f"body_{_ident(t.name)}", len(t.reads),
                          t.inner.cuda, t.kind == "cam"))
    params = [f"const float* __restrict__ in_{_ident(n)}"
              for n, _ in spec.inputs]
    params += ["float* __restrict__ partials", "float* __restrict__ keys_out"]
    L.append("__global__ void __launch_bounds__(tcopy::THREADS, 1)\n"
             "nearest_assign_kernel(" + ", ".join(params) + ") {")
    L += ["  extern __shared__ float4 smem4[];",
          "  float* const smem = reinterpret_cast<float*>(smem4);",
          "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;",
          "  float* const stage_w = smem + A::WORDS + CAM_WORDS + warp * "
          "STAGE_WORDS;  // this warp's CAM staging",
          "  (void)lane;", "  (void)stage_w;"]
    for t, o in tables:
        L.append(f"  float* const buf{t.table} = smem + A::WORDS + {o};  "
                 f"// the block's table of {t.name}")
        L.append(f"  fdag::zero(buf{t.table}, {t.keys * t.width});")
    L += _accumulators_c(others)
    L.append("  __syncthreads();")
    q_in = f"in_{_ident(spec.inputs[near.query][0])}"
    t_in = f"in_{_ident(spec.inputs[near.table][0])}"
    L.append(f"  A::walk({q_in}, {t_in}, smem, GRID, FOLD ? keys_out : "
             "nullptr, [&](long long g, const float* keys) {")
    L.append("    (void)g;")
    for t in others:
        args = ["keys + r"] * len(t.reads)
        if t.kind == "cam":
            L += _cam_step_c(spec, t, args)
            continue
        L.append(f"    // terminal {t.name} (fold)")
        L.append("    for (int r = threadIdx.x; r < BLOCK; r += blockDim.x) {")
        L.append(f"      float v[{t.width}];")
        L.append(f"      body_{_ident(t.name)}({', '.join(args + ['v'])});")
        L.append(f"      for (int j = 0; j < {t.width}; ++j) "
                 f"acc_{_ident(t.name)}[j] += v[j];")
        L.append("    }")
    L.append("  });")
    L += _partials_c(dataclasses.replace(spec, terminals=tuple(others)))
    L.append("}")
    L.append("")
    cols = max(lay.fold_cols, 32)   # a DAG without a fold: a stub's
    L.append(f"__global__ void __launch_bounds__({cols})\n"
             "nearest_fold_kernel(const float* __restrict__ x, "
             "const float* __restrict__ keys, float* __restrict__ partials) {")
    L.append("  extern __shared__ float4 smem4[];")
    L.append("  F::walk(x, keys, ROWS, partials, "
             "reinterpret_cast<float*>(smem4));")
    L.append("}")
    L.append("}  // namespace")
    L.append("")
    n_in = len(spec.inputs)
    call = ", ".join(f"(const float*)ins[{i}]" for i in range(n_in))
    v_in = f"(const float*)ins[{near.values}]" if near.fold >= 0 \
        else "nullptr"
    L.append(_ctas_source("fdag", "nearest_assign_kernel", "SMEM_BYTES",
                          ["nearest_fold_kernel"]))
    L.append(f'''// the scratch the caller allocates (codegen_cuda.scratch_words):
// the assignment blocks' partials, then the fold's chunk partials and
// the keys, each 16-byte aligned
static float* fold_partials(void* scratch, int ctas) {{
  const long long p1 = ((long long)(PARTIAL_WORDS > 0 ? PARTIAL_WORDS : 1)
                        * ctas + 3) / 4 * 4;
  return (float*)scratch + p1;
}}

static float* fold_keys(void* scratch, int ctas) {{
  return fold_partials(scratch, ctas) + F::UNITS / F::SLICES * FOLD_WORDS;
}}

static int launch_assign(void* const* ins, void* partials, int ctas,
                         cudaStream_t stream) {{
  nearest_assign_kernel<<<ctas, tcopy::THREADS, SMEM_BYTES, stream>>>(
      {call}, (float*)partials,
      FOLD ? fold_keys(partials, ctas) : nullptr);
  return (int)cudaGetLastError();
}}

// the fold's persistent blocks: as many as fit on the card, at most a
// block per unit (asked once, outside any capture)
static int fold_grid(int* grid) {{
  static int cached = 0;
  if (cached == 0) {{
    int dev = 0, sms = 0, per_sm = 0, e;
    if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (e != 0) return e;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nearest_fold_kernel, {cols}, FOLD_BYTES);
    if (e != 0) return e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached = sms * per_sm < F::UNITS ? sms * per_sm : F::UNITS;
  }}
  *grid = cached;
  return 0;
}}

static int launch_fold(void* const* ins, void* partials, int ctas,
                       cudaStream_t stream) {{
  if (!FOLD) return 0;
  int grid = 0;
  const int rc = fold_grid(&grid);
  if (rc) return rc;
  nearest_fold_kernel<<<grid, {cols}, FOLD_BYTES, stream>>>(
      {v_in}, fold_keys(partials, ctas), fold_partials(partials, ctas));
  return (int)cudaGetLastError();
}}

static int launch_combines(const float* partials, const float* init,
                           float* out, int ctas, cudaStream_t stream) {{
  int rc = fdag::launch_combine(partials, init, out, ctas, PARTIAL_WORDS,
                                stream);
  if (rc || !FOLD) return rc;
  return fdag::launch_combine(fold_partials((void*)partials, ctas),
                              init + PARTIAL_WORDS, out + PARTIAL_WORDS,
                              F::UNITS / F::SLICES, (int)FOLD_WORDS, stream);
}}

extern "C" int fdag_launch(void* const* ins, void* const* outs,
                           void* partials, int ctas, void* stream,
                           void* start, void* end) {{
  (void)outs;
  int rc = fdag::record(start, (cudaStream_t)stream);
  if (rc) return rc;
  rc = launch_assign(ins, partials, ctas, (cudaStream_t)stream);
  return rc ? rc : fdag::record(end, (cudaStream_t)stream);
}}

extern "C" int fdag_fold(void* const* ins, void* partials, int ctas,
                         void* stream, void* start, void* end) {{
  int rc = fdag::record(start, (cudaStream_t)stream);
  if (rc) return rc;
  rc = launch_fold(ins, partials, ctas, (cudaStream_t)stream);
  return rc ? rc : fdag::record(end, (cudaStream_t)stream);
}}

extern "C" int fdag_combine(const void* partials, const void* init,
                            void* out, int ctas, void* stream,
                            void* start, void* end) {{
  int rc = fdag::record(start, (cudaStream_t)stream);
  if (rc) return rc;
  rc = launch_combines((const float*)partials, (const float*)init,
                       (float*)out, ctas, (cudaStream_t)stream);
  return rc ? rc : fdag::record(end, (cudaStream_t)stream);
}}

// the assignment, the fold and the combines captured into one CUDA graph
// on a stream of its own, as dag_source's fdag_graph
extern "C" int fdag_graph(void* const* ins, void* const* outs,
                          void* partials, const void* init, void* out,
                          int ctas, void** exec) {{
  (void)outs;
  cudaStream_t s;
  cudaGraph_t graph = nullptr;
  int grid = 0;
  int rc = FOLD ? fold_grid(&grid) : 0;
  if (rc) return rc;
  rc = (int)cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (rc) return rc;
  rc = (int)cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (!rc) {{
    int lrc = launch_assign(ins, partials, ctas, s);
    if (!lrc) lrc = launch_fold(ins, partials, ctas, s);
    if (!lrc)
      lrc = launch_combines((const float*)partials, (const float*)init,
                            (float*)out, ctas, s);
    rc = (int)cudaStreamEndCapture(s, &graph);
    if (!rc) rc = lrc;
  }}
  if (!rc)
    rc = (int)cudaGraphInstantiateWithFlags((cudaGraphExec_t*)exec, graph, 0);
  if (graph) cudaGraphDestroy(graph);
  cudaStreamDestroy(s);
  return rc;
}}

extern "C" int fdag_graph_launch(void* exec, void* stream) {{
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}}

extern "C" int fdag_graph_free(void* exec) {{
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}}''')
    return "\n".join(L) + build.ERROR_STRING


PLAIN_ROWS = 1 << 18   # rows a step of the plain keyed sum of rows widens


def nearest_keys(spec: DagSpec, tensors: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Plain PyTorch version of a nearest-row DAG's stage, its kernel's
    algorithm on the whole domain: the table's row norms, then tile by
    tile ``||c||^2 - 2 x.c`` in float32 and each tile's first minimum
    replacing the running one only where strictly smaller.  Returns
    each query row's table row (int64)."""
    near = spec.nearest
    lay = near.layout
    x = tensors[spec.inputs[near.query][0]]
    c = tensors[spec.inputs[near.table][0]]
    norms = (c * c).sum(1)
    best = torch.full((x.shape[0],), float("inf"), device=x.device)
    arg = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for t0 in range(0, lay.keys, lay.tile):
        sc = norms[t0:t0 + lay.tile] - 2.0 * (x @ c[t0:t0 + lay.tile].T)
        m, i = sc.min(1)
        upd = m < best
        best = torch.where(upd, m, best)
        arg = torch.where(upd, i + t0, arg)
    return arg


def _partial_views(spec: DagSpec) -> List[Tuple[str, int, int, Tuple]]:
    """(name, first word, end word, shape) of each fold / CAM terminal's
    output in the combine's flat output."""
    return [(t.name, t.partial,
             t.partial + (int(np.prod(t.shape)) if t.shape else 1), t.shape)
            for t in spec.terminals if t.kind != "map"]


class DagKernel:
    """The megakernel of one fused DAG at one plan: its ``DagSpec``, its
    generated source, where each fold / CAM output lies in the combine's
    output (``views``) and -- from its first launch on a card -- the
    loaded library, its persistent block count and the terminals'
    ``init`` words, kept so a launch does no host work beyond it."""

    name = "fused_dag"   # the build name

    def __init__(self, spec: DagSpec):
        self.spec = spec
        self.source = nearest_source(spec) if spec.nearest is not None \
            else dag_source(spec)
        self.views = _partial_views(spec)
        self._lib = None
        self._ctas: Dict[torch.device, int] = {}
        self._init: Dict[torch.device, torch.Tensor] = {}

    def library(self):
        if self._lib is None:
            vp = ctypes.c_void_p
            self._lib = build.bind(build.load(self.name, self.source), {
                "fdag_ctas": [ctypes.POINTER(ctypes.c_int)],
                "fdag_launch": [vp, vp, vp, ctypes.c_int, vp, vp, vp],
                "fdag_combine": [vp, vp, vp, ctypes.c_int, vp, vp, vp],
                "fdag_graph": [vp, vp, vp, vp, vp, ctypes.c_int,
                               ctypes.POINTER(vp)],
                "fdag_graph_launch": [vp, vp],
                "fdag_graph_free": [vp],
                **({"fdag_fold": [vp, vp, ctypes.c_int, vp, vp, vp]}
                   if self.spec.nearest is not None else {})})
        return self._lib

    def ctas(self, dev: torch.device) -> int:
        """Persistent blocks: a few per SM as occupancy allows, at most
        one per grid step.  Raises if the card's shared memory per block
        is smaller than the plan's."""
        if dev not in self._ctas:
            spec = self.spec
            self._ctas[dev] = _persistent_ctas(
                self.library, "fdag_ctas", spec.smem_bytes, dev,
                f"fused DAG (charged {spec.onchip_bytes} B + CAM staging "
                f"{spec.staging_bytes} B)")
        return self._ctas[dev]

    def init(self, dev: torch.device) -> torch.Tensor:
        """Each fold / CAM terminal's ``init``, flat in partial order."""
        if dev not in self._init:
            flat = torch.zeros(self.spec.partial_words)
            for name, a, b, _ in self.views:
                t = next(t for t in self.spec.terminals if t.name == name)
                flat[a:b] = torch.as_tensor(t.outer.init(),
                                            dtype=torch.float32).reshape(-1)
            self._init[dev] = flat.to(dev)
        return self._init[dev]


def fused_dag_plain(spec: DagSpec, tensors: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of ``fused_dag``: the same DAG vectorised
    over the whole streaming domain, applying the patterns' torch
    bodies -- producers as whole-domain tensors, folds as sums of the
    per-index contributions, keyed folds by ``index_add_`` with keys
    outside ``[0, num_keys)`` dropped, Map terminals as whole outputs.
    Folds and keyed folds accumulate in float64 and return float32, so
    the plain version's own rounding stays far below the kernel's.  A
    nearest-row DAG's stage is ``nearest_keys`` (its terminals' reads
    name it as buffer -1), and its keyed sum of rows adds the query rows
    by those keys."""
    n = spec.grid * spec.block
    dev = _on([tensors[name] for name, _ in spec.inputs])
    i = torch.arange(n, device=dev)
    stack = (i // spec.block, i % spec.block)
    vals: Dict[int, torch.Tensor] = {}
    if spec.nearest is not None:
        arg = nearest_keys(spec, tensors)
        vals[-1] = arg.to(torch.float32)
    for k, buf in enumerate(spec.buffers):
        if buf.operand >= 0:
            vals[k] = tensors[spec.inputs[buf.operand][0]]

    def windows(reads):
        out = []
        for r in reads:
            kept = tuple(w for w in r.window if w != 1)
            v = vals[r.buffer]
            out.append(v.reshape(kept) if r.whole
                       else v.reshape((n,) + kept))
        return out

    def batched(v, elem: Tuple[int, ...]) -> torch.Tensor:
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if tuple(v.shape) != (n,) + elem:
            v = v.expand((n,) + elem)
        return v

    for s in spec.stages:
        v = s.pattern.fn(stack, *windows(s.reads))
        vals[s.out] = batched(v, tuple(s.pattern.elem_shape))
    outs: Dict[str, torch.Tensor] = {}
    for t in spec.terminals:
        wins = windows(t.reads)
        if t.kind == "map":
            v = batched(t.inner.fn(stack, *wins), tuple(t.inner.elem_shape))
            outs[t.name] = v.reshape(t.shape).contiguous()
            continue
        init = torch.as_tensor(t.outer.init(), dtype=torch.float64).to(dev)
        if t.cam_form == "sliced":   # in blocks: no float64 copy of all rows
            rows = tensors[spec.inputs[spec.nearest.values][0]]
            acc = init.clone()
            for r in range(0, n, PLAIN_ROWS):
                acc.index_add_(0, arg[r:r + PLAIN_ROWS],
                               rows[r:r + PLAIN_ROWS].double())
        elif t.kind == "fold":
            rng = tuple(t.outer.range_shape)
            zero = torch.zeros((n,) + rng, device=dev)
            contrib = batched(t.inner.fn(stack, zero, *wins), rng)
            acc = init + contrib.double().sum(0)
        else:
            key, v = t.inner.fn(stack, *wins)
            key = torch.as_tensor(key, device=dev).to(torch.int64)
            v = batched(v, tuple(t.outer.elem_shape))
            keep = (key >= 0) & (key < t.keys)
            acc = init.index_add(0, key[keep], v[keep].double())
        outs[t.name] = acc.float()
    return outs


def fused_dag(kernel: DagKernel, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Run the fused-DAG megakernel on ``tensors`` (name -> float32
    tensor); returns name -> output.

    Replaces the TPU kernel ``lower_fused_dag`` (reference
    codegen_pallas.py).  Bound by main-memory bytes: inputs are read
    once through the plan's ``depth``-slot ``cp.async`` ring,
    intermediates stay on chip, CAM terminals add into per-warp tables
    without atomics, and each persistent block writes one partial per
    fold / CAM terminal that a second launch sums in block order, so two
    calls are bitwise equal.  CPU tensors take ``fused_dag_plain``; CUDA
    tensors launch the kernel or raise.
    """
    spec = kernel.spec
    with telemetry.span("fused_dag.stage"):
        ins = []
        for name, shape in spec.inputs:
            _f32(name, tensors[name], shape)
            ins.append(tensors[name])
        dev = _on(ins)
        if dev.type != "cpu":
            _aligned([(name, tensors[name]) for name, _ in spec.inputs])
    if dev.type == "cpu":
        return fused_dag_plain(spec, tensors)
    with telemetry.span("fused_dag.launch"):
        lib = kernel.library()
        ctas = kernel.ctas(dev)
        cur = torch.cuda.current_stream(dev)
        stream = cur.cuda_stream
        maps = {t.name: torch.empty(t.shape, dtype=torch.float32,
                                    device=dev)
                for t in spec.terminals if t.kind == "map"}
        partials = torch.empty(scratch_words(spec, ctas),
                               dtype=torch.float32, device=dev)
        in_ptrs = build.pointers([t.data_ptr() for t in ins])
        out_ptrs = build.pointers([m.data_ptr() for m in maps.values()])
        # the C entry point records the device span's events (if any)
        # right around the kernel
        with telemetry.device_span("fused_dag.kernel", cur) as ev:
            rc = lib.fdag_launch(ctypes.cast(in_ptrs, ctypes.c_void_p),
                                 ctypes.cast(out_ptrs, ctypes.c_void_p),
                                 partials.data_ptr(), ctas, stream,
                                 *ev.events)
            build.check(lib, rc, "fused_dag launch")
        fused_dag.launches += 1
    near = spec.nearest
    if near is not None:
        _count_tiles(spec)
        if near.fold >= 0:
            with telemetry.span("fused_dag.fold"), \
                    telemetry.device_span("fused_dag.fold", cur) as ev:
                rc = lib.fdag_fold(ctypes.cast(in_ptrs, ctypes.c_void_p),
                                   partials.data_ptr(), ctas, stream,
                                   *ev.events)
                build.check(lib, rc, "fused_dag fold")
    outs: Dict[str, torch.Tensor] = dict(maps)
    if spec.partial_words:
        with telemetry.span("fused_dag.combine"):
            flat = torch.empty(spec.partial_words, dtype=torch.float32,
                               device=dev)
            init = kernel.init(dev).data_ptr()
            with telemetry.device_span("fused_dag.combine", cur) as ev:
                rc = lib.fdag_combine(partials.data_ptr(), init,
                                      flat.data_ptr(), ctas, stream,
                                      *ev.events)
                build.check(lib, rc, "fused_dag combine")
            for name, a, b, shape in kernel.views:
                outs[name] = flat[a:b].reshape(shape)
    telemetry.count("fused_dag.eager_calls")
    return {t.name: outs[t.name] for t in spec.terminals}


fused_dag.launches = 0


def _count_tiles(spec: DagSpec) -> None:
    """A nearest-row DAG call's table tiles and fold column slices."""
    lay = spec.nearest.layout
    telemetry.count("fused_dag.table_tiles", lay.tiles)
    telemetry.count("fused_dag.column_slices", lay.slices)


# --------------------------------------------------------------------
# Replays: a fused-DAG call as one CUDA graph, keyed on its inputs
# --------------------------------------------------------------------

DAG_GRAPHS = 128   # graphs a fused-DAG callable keeps, the oldest dropped
                   # first: one per input signature, so the partitions of
                   # a table cut in up to 128 pieces each keep theirs


def current_stream(dev: torch.device) -> Tuple[int, int]:
    """(device index, handle) of the stream a launch on ``dev`` goes to,
    ``torch.cuda.current_stream(dev)``'s, read without building a
    ``torch.cuda.Stream``: the public call costs more than the rest of
    a replay's lookup."""
    index = torch._C._cuda_getDevice() if dev.index is None else dev.index
    return index, torch._C._cuda_getCurrentRawStream(index)


def dag_signature(tensors: Dict[str, Any], names: Sequence[str],
                  stream) -> Optional[tuple]:
    """What an eager launch's checks and pointers depend on: the stream
    the call launches on (``current_stream``; first), then each input's
    address, shape, strides, dtype and device.  None when an input is
    no tensor."""
    key: List[Any] = [stream]
    for name in names:
        t = tensors[name]
        if not isinstance(t, torch.Tensor):
            return None
        key.append((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device))
    return tuple(key)


def graphable(spec: DagSpec, dev: torch.device) -> bool:
    """Can a call of this DAG on ``dev`` replay one CUDA graph: on the
    card, with every terminal a fold or a CAM, so that a replay's output
    is the combine's few words (a Map terminal writes a whole output,
    which a replay would have to copy out)."""
    return dev.type == "cuda" and all(t.kind != "map"
                                      for t in spec.terminals)


def replayable(spec: DagSpec, dev: torch.device, tensors: Dict[str, Any],
               staged: Dict[str, torch.Tensor]) -> bool:
    """May this call's launch be kept as a graph for its signature:
    ``graphable``, no device span times the launches (they time eager
    ones), and staging left every input as the caller gave it (a copy
    has no address that lasts)."""
    return graphable(spec, dev) and not telemetry.device_enabled() and all(
        staged[name] is tensors[name] for name, _ in spec.inputs)


class DagGraph:
    """The megakernel and its combine over fixed inputs, as one CUDA
    graph (``fdag_graph``) with partials and a flat output of its own.
    The executable graph is destroyed with the object."""

    def __init__(self, kernel: DagKernel, ins: Sequence[torch.Tensor],
                 dev: torch.device, stream: int):
        spec = kernel.spec
        self.exec = None
        self.lib = kernel.library()
        self.stream = stream
        self.views = kernel.views
        ctas = kernel.ctas(dev)
        self.spec = spec
        self.partials = torch.empty(scratch_words(spec, ctas),
                                    dtype=torch.float32, device=dev)
        self.flat = torch.empty(spec.partial_words, dtype=torch.float32,
                                device=dev)
        self._lock = threading.Lock()
        in_ptrs = build.pointers([t.data_ptr() for t in ins])
        exe = ctypes.c_void_p()
        rc = self.lib.fdag_graph(ctypes.cast(in_ptrs, ctypes.c_void_p), None,
                                 self.partials.data_ptr(),
                                 kernel.init(dev).data_ptr(),
                                 self.flat.data_ptr(), ctas,
                                 ctypes.byref(exe))
        build.check(self.lib, rc, "fused_dag graph capture")
        self.exec = exe.value

    def replay(self) -> Dict[str, torch.Tensor]:
        """Launch the graph on its stream; the outputs, in fresh storage
        that no later replay writes."""
        with self._lock:      # a replay rewrites the flat output
            build.check(self.lib,
                        self.lib.fdag_graph_launch(self.exec, self.stream),
                        "fused_dag graph launch")
            flat = self.flat.clone()
        fused_dag.launches += 1
        telemetry.count("fused_dag.graph_replays")
        if self.spec.nearest is not None:
            _count_tiles(self.spec)
        return {name: flat[a:b].reshape(shape)
                for name, a, b, shape in self.views}

    def __del__(self):
        if self.exec:
            # a graph still running is freed when it completes
            self.lib.fdag_graph_free(self.exec)


class DagGraphs:
    """A fused-DAG callable's graphs by input signature
    (``dag_signature``), at most ``DAG_GRAPHS``."""

    def __init__(self, kernel: DagKernel, dev: torch.device):
        self.kernel, self.dev = kernel, dev
        self.names = tuple(name for name, _ in kernel.spec.inputs)
        self.plans: Dict[tuple, DagGraph] = {}
        self._lock = threading.Lock()

    def key(self, tensors: Dict[str, Any]) -> Optional[tuple]:
        """The call's signature, or None while device spans are on."""
        if telemetry.device_enabled():
            return None
        return dag_signature(tensors, self.names, current_stream(self.dev))

    def capture(self, key: tuple, staged: Dict[str, torch.Tensor]) -> None:
        _, stream = key[0]
        graph = DagGraph(self.kernel, [staged[n] for n in self.names],
                         self.dev, stream)
        with self._lock:
            while len(self.plans) >= DAG_GRAPHS:
                del self.plans[next(iter(self.plans))]
            self.plans[key] = graph
        telemetry.count("fused_dag.graph_captures")


def lower_fused_dag(terminals, grid_n: int, depth: int = 2, *,
                    device=None) -> Callable:
    """ONE CUDA kernel for a fused pipeline DAG.

    ``terminals`` is a sequence of ``(output name, fused pattern)``
    pairs (``pipeline.fuse_dag`` output) sharing the 1-D strided grid
    ``grid_n``.  External tensors stream through ``depth``-slot shared
    tiles (one per distinct tile, however many terminal trees read it),
    filled by ``cp.async`` ``depth - 1`` steps ahead; every producer
    stage runs once per grid step into its ``depth``-slot scratch and is
    consumed in place by all its readers; each terminal folds, adds into
    its CAM table (the form ``cam_forms`` picks), or streams its Map
    block out.  Main memory is touched solely at the pipeline edges
    (paper Fig. 6).  On a card, a plan whose CAM staging does not fit
    beside its charge raises ``ValueError`` here.  A DAG whose stage is a
    nearest-row Map lowers to ``nearest_dag.cuh``'s kernels
    (``_nearest_spec``).  Returns
    ``call(**tensors) -> {name: tensor}`` with ``.kernel`` (the
    ``DagKernel``: its spec and generated source) and ``.graphs``.

    Where the DAG is ``graphable``, ``.graphs`` (``DagGraphs``) keeps
    a call's two launches as one CUDA graph under the call's
    ``dag_signature``: the first call with a signature runs the eager
    path in full and captures the graph (``replayable`` says when), and
    each later one looks the signature up and replays the graph, with
    the same answer bit for bit.  Counters ``fused_dag.graph_captures``,
    ``fused_dag.graph_replays``; ``fused_dag.eager_calls`` counts the
    wrapper's launches.
    """
    dev = resolve(device)
    limit = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin if dev.type == "cuda" else None
    with telemetry.span("codegen.lower_fused_dag",
                        terminals=len(terminals), grid=int(grid_n),
                        depth=int(depth)):
        kernel = DagKernel(dag_spec(terminals, grid_n, depth,
                                    smem_limit=limit))
    for t in kernel.spec.terminals:
        if t.kind == "cam":
            telemetry.count(f"fused_dag.cam_form.{t.cam_form}")

    graphs = DagGraphs(kernel, dev) if graphable(kernel.spec, dev) else None

    def call(**tensors):
        with telemetry.span("fused_dag.call"):
            key = None
            if graphs is not None:
                with telemetry.span("fused_dag.stage"):
                    key = graphs.key(tensors)
                    graph = graphs.plans.get(key)
                if graph is not None:
                    with telemetry.span("fused_dag.launch"):
                        return graph.replay()
            with telemetry.span("fused_dag.stage"):
                ts = {name: _staged(tensors[name], dev)
                      for name, _ in kernel.spec.inputs}
            out = fused_dag(kernel, ts)
            if key is not None and replayable(kernel.spec, dev, tensors, ts):
                graphs.capture(key, ts)
            return out

    call.kernel = kernel
    call.graphs = graphs
    return call


def lower_fused_chain(p: ir.Pattern, depth: int = 2, *,
                      device=None) -> Callable:
    """Single-terminal front-end over ``lower_fused_dag``: one fused
    pattern in, the bare output tensor out."""
    if not (p.strided and len(p.domain) == 1):
        raise NotImplementedError("fused chain: 1-D strided root expected")
    (grid_n,) = p.domain
    dag_call = lower_fused_dag(((p.name, p),), grid_n, depth=depth,
                               device=device)

    def call(**tensors):
        return dag_call(**tensors)[p.name]

    call.kernel = dag_call.kernel
    return call


def lower_fused_pipeline(pipe, *, plan=None,
                         vmem_budget: Optional[int] = None, device=None,
                         tier=None, cache=None, measure: Optional[str] = None,
                         policy=None, options=None) -> Callable:
    """Lower a ``pipeline.Pipeline`` (DAG) with a joint-DSE
    ``PipelinePlan``.

    ``plan=None`` runs ``dse.explore_pipeline`` on the card's tier (or
    ``tier``), with ``cache``, ``measure``, ``policy`` (a
    ``resilience.Policy``) and ``options`` passed through (measured
    mode, deadlines, quarantine, certification).  Each plan group lowers
    as one multi-output megakernel (``lower_fused_dag``) at its own
    block size and depth; group boundaries -- present only on the
    split-fallback path -- materialize their cut intermediates and chain
    through them.  A group whose shape the template does not take runs
    the per-stage oracle chain on the CPU; on the card it raises
    ``NotImplementedError`` naming the group, so no group runs plain
    PyTorch on CUDA tensors.  The plan is exposed on the returned
    callable as ``.pipeline_plan``, ``.group_lowerings`` records what
    each group compiled to (``megakernel`` / ``oracle-chain``) and
    ``.group_calls`` holds the per-group callables (a megakernel's
    carries its ``DagKernel``).  Multi-output pipelines return a name ->
    tensor dict.
    """
    from . import pipeline as plmod
    from .cost import device_tier
    from .dse import explore_pipeline

    dev = resolve(device)
    tier = device_tier(dev) if tier is None else tier
    budget = tier.onchip_bytes if vmem_budget is None else vmem_budget
    if plan is None:
        plan = explore_pipeline(pipe, tier=tier, vmem_budget=budget,
                                device=dev, cache=cache, measure=measure,
                                policy=policy, options=options)

    runners = []
    lowerings = []
    for (i0, i1), b, d in zip(plan.groups, plan.group_blocks, plan.depths):
        sub = plmod.sub_pipeline(pipe, i0, i1)
        outs = plmod.output_names(sub)
        try:
            fdag = plmod.fuse_dag(sub, b, vmem_budget_words=budget // 4)
            runner = lower_fused_dag(fdag.terminals, fdag.grid, depth=d,
                                     device=dev)
            how = "megakernel"
        except NotImplementedError as e:
            if dev.type != "cpu":
                raise NotImplementedError(
                    f"group {list(outs)} of '{pipe.name}' has no CUDA "
                    f"megakernel: {e}") from e
            chain = plmod.unfused_runner(sub, device=dev)  # correctness first

            def runner(_chain=chain, _names=outs, **tensors):
                out = _chain(**tensors)
                return out if isinstance(out, dict) else {_names[0]: out}

            how = "oracle-chain"
        runners.append(runner)
        lowerings.append((outs[-1], how))

    out_names = plmod.output_names(pipe)
    seq = itertools.count(1)
    # one megakernel that replays graphs reads the caller's tensors as
    # they are, before it stages them, so a replay makes no per-input op
    direct = len(runners) == 1 and getattr(runners[0], "graphs", None) \
        is not None

    def call(**tensors):
        with telemetry.span("pipeline.call", pipeline=pipe.name,
                            seq=next(seq)):
            if direct:
                env = tensors
            else:
                with telemetry.span("fused_dag.stage"):
                    env = {k: torch.as_tensor(v).to(dev)
                           for k, v in tensors.items()}
            for runner in runners:
                env.update(runner(**env))
            if len(out_names) == 1:
                return env[out_names[0]]
            return {n: env[n] for n in out_names}

    call.pipeline_plan = plan
    call.group_lowerings = tuple(lowerings)
    call.group_calls = tuple(runners)   # a megakernel's has .kernel
    return call


# --------------------------------------------------------------------
# Tiled Map (write-once) and tiled FlatMap (parallel FIFO):
#   MultiFold(grid) write-once { loads; Map(tile) }
#   FlatMap(grid) { loads; FlatMap(tile) }
# --------------------------------------------------------------------

# sizeof(tfm::Scan): the FlatMap's scan scratch after the charged buffers
# (8 warp counts, 8 + 8 look-back words, the total, padding to 16 bytes)
FLATMAP_SCAN_BYTES = 112


def _row_major(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, s = [], 1
    for e in reversed(shape):
        strides.append(s)
        s *= int(e)
    return tuple(reversed(strides))


def _words(shape: Sequence[int]) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _is_run(part: Sequence[int], whole: Sequence[int]) -> bool:
    """A row-major block ``part`` of ``whole`` is one contiguous run:
    after its first dim longer than 1, it spans every dim whole."""
    big = [d for d, e in enumerate(part) if e > 1]
    return all(part[d] == whole[d]
               for d in range(big[0] + 1 if big else len(part), len(part)))


@dataclasses.dataclass(frozen=True)
class TileLoad:
    """A tensor tile the kernel stages in shared memory: at grid index
    ``g`` it starts at flat source offset ``origin + sum_j step[j] *
    g[j]``."""

    label: str
    operand: int                   # index into TiledSpec.inputs
    shape: Tuple[int, ...]         # the source tensor's
    tile: Tuple[int, ...]
    origin: int
    step: Tuple[int, ...]          # flat offset per unit of each grid index
    slots: int                     # the depth, or 1 for a hoisted preload

    @property
    def words(self) -> int:
        return _words(self.tile)

    @property
    def contiguous(self) -> bool:
        """The tile is one run of its source."""
        return _is_run(self.tile, self.shape)

    @property
    def vec4(self) -> bool:
        """Copyable in 16-byte pieces (given a 16-byte aligned slot)."""
        return (self.contiguous and self.words % 4 == 0
                and self.origin % 4 == 0 and all(s % 4 == 0 for s in self.step))


@dataclasses.dataclass(frozen=True)
class TileRead:
    """A window the body reads from a staged tile at each local index
    ``l``: along tile dim ``d`` it starts at ``clamp(sum_j local[d][j] *
    l[j], 0, tile[d] - window[d])``, as ``dynamic_slice`` clamps."""

    load: int
    window: Tuple[int, ...]
    local: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class TiledSpec:
    """What the kernel of one tiled Map or FlatMap at one plan computes.

    A Map writes ``width`` words per local index at flat output offset
    ``out_origin + sum_j out_step[j] * g[j] + sum_j out_local[j] *
    l[j]``; a FlatMap's body emits up to ``width`` values per index
    into a buffer of ``out_shape`` words plus a count."""

    kind: str                      # "map" | "flatmap"
    grid: Tuple[int, ...]
    domain: Tuple[int, ...]        # the tile's local domain
    depth: int
    inputs: Tuple[Tuple[str, Tuple[int, ...]], ...]   # operand order
    loads: Tuple[TileLoad, ...]
    reads: Tuple[TileRead, ...]
    body: ir.Pattern               # the tile pattern (torch + CUDA body)
    width: int
    out_shape: Tuple[int, ...]
    out_origin: int = 0
    out_step: Tuple[int, ...] = ()
    out_local: Tuple[int, ...] = ()

    @property
    def steps(self) -> int:
        return _words(self.grid)

    @property
    def tile_n(self) -> int:
        return _words(self.domain)

    @property
    def fifo_words(self) -> int:
        """The FlatMap's compaction FIFO: b * max_per_iter words."""
        return self.tile_n * self.width if self.kind == "flatmap" else 0

    @property
    def tile_bytes(self) -> int:
        return 4 * sum(ld.words * ld.slots for ld in self.loads)

    @property
    def onchip_bytes(self) -> int:
        """What ``memory.plan_memory`` charges: tiles and FIFO."""
        return self.tile_bytes + 4 * self.fifo_words

    @property
    def scan_bytes(self) -> int:
        """The FlatMap's scan scratch, counted beside the charge."""
        return FLATMAP_SCAN_BYTES if self.kind == "flatmap" else 0

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared bytes a block: the charge and the scan scratch."""
        return self.onchip_bytes + self.scan_bytes


def _check_block_aligned(amap: AffineMap, tile: Tuple[int, ...],
                         what: str) -> None:
    """The reference's BlockSpec index maps address whole blocks: every
    base offset and grid stride must be a multiple of the tile extent."""
    for d in range(amap.n_out):
        if amap.base[d] % tile[d]:
            raise ValueError(
                f"{what}: base {amap.base} is not block-aligned (dim {d} "
                f"offset {amap.base[d]} is not a multiple of tile extent "
                f"{tile[d]})")
        for j in range(amap.n_in):
            if amap.mat[d][j] % tile[d]:
                raise ValueError(
                    f"{what}: stride {amap.mat[d][j]} (dim {d}, grid dim "
                    f"{j}) is not a multiple of tile extent {tile[d]}; "
                    "the grid would address partial blocks")


def _check_inside(amap: AffineMap, grid: Tuple[int, ...],
                  tile: Tuple[int, ...], shape: Tuple[int, ...],
                  what: str) -> None:
    for d in range(amap.n_out):
        reach = [s * (g - 1) for s, g in zip(amap.mat[d], grid)]
        lo = amap.base[d] + sum(min(0, r) for r in reach)
        hi = amap.base[d] + sum(max(0, r) for r in reach) + tile[d]
        if lo < 0 or hi > shape[d]:
            raise ValueError(f"{what}: blocks reach [{lo}, {hi}) along dim "
                             f"{d} of a tensor of shape {shape}")


def _flat(amap: AffineMap, shape: Tuple[int, ...]) -> Tuple[int, Tuple]:
    """(flat origin, flat step per input index) of an affine map into a
    row-major tensor of ``shape``."""
    strides = _row_major(shape)
    origin = sum(b * s for b, s in zip(amap.base, strides))
    step = tuple(sum(amap.mat[d][j] * strides[d] for d in range(amap.n_out))
                 for j in range(amap.n_in))
    return origin, step


def tiled_spec(p: ir.Pattern, depth: int = 2) -> TiledSpec:
    """Analyse a tiled Map (``MultiFold(grid) write-once {Map(tile)}``)
    or tiled FlatMap (``FlatMap(grid) {FlatMap(tile)}``) into its
    kernel's tiles, windows and output addressing.

    Raises ``ValueError`` for a tile copy or output block that is not
    block-aligned (as the reference's BlockSpecs do) and
    ``NotImplementedError`` for shapes the templates do not take: a
    read that is not tile-local, a tile element that is itself a
    pattern (the nested-fold GEMM form), a staged pattern, non-float32
    data, or FlatMap values wider than one word."""
    from .fusion import tile_copy_key

    if depth < 2:
        raise ValueError(f"metapipeline depth must be >= 2, got {depth}")
    if isinstance(p, ir.MultiFold) and p.combine is None \
            and isinstance(p.inner, ir.Map):
        kind = "map"
    elif isinstance(p, ir.FlatMap) and isinstance(p.inner, ir.FlatMap):
        kind = "flatmap"
    else:
        raise NotImplementedError(
            f"no tiled Map or FlatMap template for {type(p).__name__} "
            f"'{p.name}'")
    q = p.inner
    if not p.strided:
        raise NotImplementedError(f"'{p.name}' is not a strided grid")
    if q.inner is not None:
        raise NotImplementedError(
            f"'{q.name}': no template takes a tile element that is itself "
            f"a pattern ({type(q.inner).__name__} '{q.inner.name}')")
    if q.loads:
        raise NotImplementedError(f"'{q.name}' stages tiles of its own")
    if "float32" != p.dtype or "float32" != q.dtype:
        raise NotImplementedError(f"'{p.name}' is {p.dtype}")
    if kind == "flatmap" and q.elem_shape:
        raise NotImplementedError(
            f"'{q.name}': FlatMap values wider than one word")
    grid = tuple(int(d) for d in p.domain)
    dom = tuple(int(d) for d in q.domain)

    inputs: List[Tuple[str, Tuple[int, ...]]] = []
    loads: List[TileLoad] = []
    by_uid: Dict[str, int] = {}
    by_key: Dict[Any, int] = {}
    for tc in p.loads:
        if not isinstance(tc.src, ir.Tensor):
            raise NotImplementedError(
                f"'{p.name}' stages a pattern-valued tile '{tc.name}'")
        key = tile_copy_key(tc)
        if key in by_key:
            by_uid[tc.uid] = by_key[key]
            continue
        if tc.src.dtype != "float32":
            raise NotImplementedError(f"input '{tc.src.name}' is "
                                      f"{tc.src.dtype}")
        shape, tile_ = tuple(tc.src.shape), tuple(tc.tile_shape)
        amap = _probe(tc.index_map, len(grid))
        if amap.n_in != len(grid):
            raise NotImplementedError(
                f"tile copy of '{tc.src.name}' is not indexed by the grid")
        what = f"tile copy of '{tc.src.name}'"
        _check_block_aligned(amap, tile_, what)
        _check_inside(amap, grid, tile_, shape, what)
        names = [n for n, _ in inputs]
        if tc.src.name not in names:
            inputs.append((tc.src.name, shape))
            names.append(tc.src.name)
        origin, step = _flat(amap, shape)
        loads.append(TileLoad(tc.src.name, names.index(tc.src.name), shape,
                              tile_, origin, step,
                              1 if tc.hoisted else depth))
        by_key[key] = by_uid[tc.uid] = len(loads) - 1
    if not loads:
        raise NotImplementedError(f"'{p.name}' reads no tensor tile")

    n_stack = len(grid) + len(dom)
    reads: List[TileRead] = []
    for a in q.accesses:
        if not (isinstance(a.src, ir.TileCopy) and a.src.uid in by_uid):
            raise NotImplementedError(
                f"'{q.name}' reads {a.src!r}, which is not one of its "
                "tiles: the read is not tile-local")
        ld = by_uid[a.src.uid]
        amap = _probe(a.index_map, n_stack)
        window = tuple(a.window)
        if amap.n_in != n_stack or any(amap.base) or any(
                amap.mat[d][j] for d in range(amap.n_out)
                for j in range(len(grid))):
            raise NotImplementedError(
                f"'{q.name}' reads a window of '{loads[ld].label}' that is "
                "not tile-local")
        if len(window) != len(loads[ld].tile) or any(
                w > t for w, t in zip(window, loads[ld].tile)):
            raise NotImplementedError(
                f"'{q.name}': window {window} of tile {loads[ld].tile}")
        reads.append(TileRead(ld, window, tuple(
            tuple(amap.mat[d][len(grid):]) for d in range(amap.n_out))))

    out: Dict[str, Any] = {}
    if kind == "map":
        elem = tuple(q.elem_shape)
        rng = tuple(p.range_shape)
        upd = tuple(p.update_shape)
        if upd != dom + elem or rng[len(dom):] != elem:
            raise NotImplementedError(
                f"'{p.name}': output block {upd} is not the tile {dom} "
                f"times the element {elem}")
        omap = AffineMap.probe(lambda *g: p.out_index_map(*g), len(grid))
        what = f"output block of '{p.name}'"
        _check_block_aligned(omap, upd, what)
        _check_inside(omap, grid, upd, rng, what)
        origin, step = _flat(omap, rng)
        out = dict(width=_words(elem), out_shape=rng, out_origin=origin,
                   out_step=step, out_local=_row_major(rng)[:len(dom)])
    else:
        cap = _words(grid) * _words(dom) * q.max_per_iter
        if cap >= 2 ** 31:
            raise NotImplementedError(
                f"'{p.name}': a buffer of {cap} words needs 64-bit counts")
        out = dict(width=int(q.max_per_iter), out_shape=(cap,))

    # 16-byte copyable tiles first, so their slots stay 16-byte aligned
    perm = sorted(range(len(loads)), key=lambda i: not loads[i].vec4)
    remap = {old: new for new, old in enumerate(perm)}
    return TiledSpec(
        kind=kind, grid=grid, domain=dom, depth=int(depth),
        inputs=tuple(inputs), loads=tuple(loads[i] for i in perm),
        reads=tuple(dataclasses.replace(r, load=remap[r.load])
                    for r in reads),
        body=q, **out)


# ------------------------------------------------------ source emission


def _affine(const: int, coefs: Sequence[int], names: Sequence[str],
            suffix: str = "LL") -> str:
    terms = [f"{const}{suffix}"] if const or not any(coefs) else []
    terms += [f"{n} * {c}{suffix}" for c, n in zip(coefs, names) if c]
    return "(" + " + ".join(terms) + ")"


def _unflatten_c(var: str, dims: Sequence[int], ctype: str) -> List[str]:
    """Bind ``<var>0 ..`` to the row-major multi-index of ``var``."""
    if len(dims) == 1:
        return [f"const {ctype} {var}0 = {var};"]
    lines = [f"{ctype} {var}_r = {var};"]
    for d in range(len(dims) - 1, 0, -1):
        lines.append(f"const {ctype} {var}{d} = {var}_r % {dims[d]}; "
                     f"{var}_r /= {dims[d]};")
    lines.append(f"const {ctype} {var}0 = {var}_r;")
    return lines


def _tiled_buffers(spec: TiledSpec, fifo: bool = False) -> List[str]:
    """Shared-memory layout: each tile at its slots, then the FIFO."""
    lines = ["  extern __shared__ float4 smem4[];",
             "  float* const smem = reinterpret_cast<float*>(smem4);"]
    off = 0
    for k, ld in enumerate(spec.loads):
        lines.append(f"  float* const buf{k} = smem + {off};  // tile of "
                     f"{ld.label}: {ld.slots} x {ld.words} words")
        off += ld.words * ld.slots
    if fifo:
        lines.append(f"  float* const fifo = smem + {off};  // "
                     f"{spec.fifo_words} words")
    return lines


def _copy_c(spec: TiledSpec, k: int, dst: str, gvars: Sequence[str]
            ) -> List[str]:
    ld = spec.loads[k]
    src = f"in{ld.operand} + {_affine(ld.origin, ld.step, gvars)}"
    if ld.vec4:
        return [f"tcopy::copy_vec4({dst}, {src}, {ld.words});"]
    if ld.contiguous:
        return [f"tcopy::copy_scalar({dst}, {src}, {ld.words});"]
    strides = _row_major(ld.shape)
    at = " + ".join(f"e{d} * {s}LL" for d, s in enumerate(strides))
    return (["{", f"  const float* const src = {src};",
             f"  for (int e = threadIdx.x; e < {ld.words}; e += blockDim.x) {{"]
            + ["    " + x for x in _unflatten_c("e", ld.tile, "int")]
            + [f"    {dst}[e] = src[{at}];", "  }", "}"])


def _step_c(spec: TiledSpec) -> List[str]:
    """Body of one grid step up to the tiles' barrier: the grid index,
    the slots and the copies (hoisted tiles are copied before the
    loop)."""
    gvars = [f"g{j}" for j in range(len(spec.grid))]
    lines = _unflatten_c("g", spec.grid, "long long")
    lines.append("const int slot = step % DEPTH;")
    for k, ld in enumerate(spec.loads):
        if ld.slots == 1:
            lines.append(f"float* const t{k} = buf{k};")
        else:
            lines.append(f"float* const t{k} = buf{k} + slot * {ld.words};")
            lines += _copy_c(spec, k, f"t{k}", gvars)
    lines.append("__syncthreads();")
    return lines


def _hoisted_c(spec: TiledSpec) -> List[str]:
    lines = []
    for k, ld in enumerate(spec.loads):
        if ld.slots == 1:
            lines += ["  " + x for x in
                      _copy_c(spec, k, f"buf{k}", ["0"] * len(spec.grid))]
    return lines


def _windows_c(spec: TiledSpec) -> Tuple[List[str], List[str]]:
    """Lines binding ``w<r>`` to each read's window at local index
    ``l0 ..`` (a pointer into the tile, or a gathered copy where the
    window is not one run of the tile), and the body's arguments."""
    lvars = [f"l{j}" for j in range(len(spec.domain))]
    lines, args = [], []
    for r, rd in enumerate(spec.reads):
        ld = spec.loads[rd.load]
        ts = _row_major(ld.tile)
        parts = []
        for d, row in enumerate(rd.local):
            if not any(row):
                continue
            start = _affine(0, row, lvars, suffix="")
            parts.append(f"tmap::clamp_start({start}, "
                         f"{ld.tile[d] - rd.window[d]}) * {ts[d]}")
        at = " + ".join(parts) or "0"
        if _is_run(rd.window, ld.tile):
            lines.append(f"const float* const w{r} = t{rd.load} + {at};")
        else:
            n = _words(rd.window)
            inner = " + ".join(f"e{d} * {ts[d]}"
                               for d in range(len(rd.window)))
            lines += [f"float w{r}[{n}];", "{", f"  const int at = {at};",
                      f"  for (int e = 0; e < {n}; ++e) {{"]
            lines += ["    " + x for x in _unflatten_c("e", rd.window, "int")]
            lines += [f"    w{r}[e] = t{rd.load}[at + {inner}];", "  }", "}"]
        args.append(f"w{r}")
    return lines, args


def _tiled_header(spec: TiledSpec, template: str) -> List[str]:
    return [f"// tiled {spec.kind} ({spec.body.name}) at grid {spec.grid}, "
            f"tile {spec.domain}, depth {spec.depth};",
            f"// generated by codegen_cuda from {template}",
            f'#include "{template}"', "", "namespace {",
            f"constexpr int DEPTH = {spec.depth};",
            f"constexpr long long GRID = {spec.steps}LL;",
            f"constexpr int TILE_N = {spec.tile_n};",
            f"constexpr int SMEM_BYTES = {spec.smem_bytes};", ""]


def _need_cuda_body(spec: TiledSpec) -> str:
    if spec.body.cuda is None:
        raise NotImplementedError(f"'{spec.body.name}' has no CUDA body")
    return spec.body.cuda


def map_source(spec: TiledSpec) -> str:
    """The translation unit of one tiled Map at one plan: the template
    ``tiled_map.cuh`` instantiated with the Map's body, the grid and
    tile domains and each tile's affine window.  Deterministic."""
    assert spec.kind == "map"
    L = _tiled_header(spec, "tiled_map.cuh")
    L.append(_body_fn("body", len(spec.reads), _need_cuda_body(spec)))
    params = [f"const float* __restrict__ in{i}"
              for i in range(len(spec.inputs))] + ["float* __restrict__ out"]
    L.append("__global__ void __launch_bounds__(tcopy::THREADS)\n"
             "tiled_map_kernel(" + ", ".join(params) + ") {")
    L += _tiled_buffers(spec) + _hoisted_c(spec)
    L.append("  int step = 0;")
    L.append("  for (long long g = blockIdx.x; g < GRID; "
             "g += gridDim.x, ++step) {")
    L += ["    " + x for x in _step_c(spec)]
    gvars = [f"g{j}" for j in range(len(spec.grid))]
    lvars = [f"l{j}" for j in range(len(spec.domain))]
    L.append(f"    float* const o = out + "
             f"{_affine(spec.out_origin, spec.out_step, gvars)};")
    L.append("    for (int l = threadIdx.x; l < TILE_N; l += blockDim.x) {")
    L += ["      " + x for x in _unflatten_c("l", spec.domain, "int")]
    wl, args = _windows_c(spec)
    L += ["      " + x for x in wl]
    dst = f"o + {_affine(0, spec.out_local, lvars)}"
    L.append(f"      body({', '.join(args + [dst])});")
    L += ["    }", "  }", "}", "}  // namespace", ""]
    L.append(_ctas_source("tmap", "tiled_map_kernel", "SMEM_BYTES"))
    call = ", ".join([f"(const float*)ins[{i}]"
                      for i in range(len(spec.inputs))] + ["(float*)out"])
    L.append(f'''extern "C" int tmap_launch(void* const* ins, void* out,
                           int ctas, void* stream) {{
  tiled_map_kernel<<<ctas, tcopy::THREADS, SMEM_BYTES,
                     (cudaStream_t)stream>>>({call});
  return (int)cudaGetLastError();
}}''')
    return "\n".join(L) + build.ERROR_STRING


def _flatmap_fill(spec: TiledSpec, loads: Sequence[int]) -> Callable:
    """``fill`` for ``_ring_c``: the ``cp.async`` copies of the 16-byte
    copyable streamed tiles ``loads`` of grid step ``g``."""
    def fill(indent: str, slot: str, g: str) -> List[str]:
        if not loads:
            return []
        gvars = [f"{g}{j}" for j in range(len(spec.grid))]
        lines = [indent + "{"]
        lines += [indent + "  " + x
                  for x in _unflatten_c(g, spec.grid, "long long")]
        for k in loads:
            ld = spec.loads[k]
            src = f"in{ld.operand} + {_affine(ld.origin, ld.step, gvars)}"
            lines.append(f"{indent}  fdag::copy_async(buf{k} + ({slot}) * "
                         f"{ld.words}, {src}, {ld.words});")
        return lines + [indent + "}"]
    return fill


def flatmap_source(spec: TiledSpec) -> str:
    """The translation unit of one tiled FlatMap at one plan: the one-pass
    tile kernel of ``tiled_flatmap.cuh`` instantiated with the FlatMap's
    body and each tile's affine window -- tiles through the ``cp.async``
    ring (``_ring_c``; tiles that are not 16-byte copyable copied
    synchronously), each warp's segment compacted in its FIFO region,
    the tile offset by decoupled look-back and copied out -- and its
    cooperative launch.  Deterministic."""
    assert spec.kind == "flatmap"
    L = _tiled_header(spec, "tiled_flatmap.cuh")
    L += [f"constexpr int M = {spec.width};",
          "constexpr int SEG = (TILE_N + tfm::WARPS - 1) / tfm::WARPS;",
          f"constexpr long long CAP = {spec.out_shape[0]}LL;",
          f"constexpr int CHARGE_BYTES = {spec.onchip_bytes};  "
          "// tiles and FIFO: the plan's charge",
          "static_assert(SMEM_BYTES == CHARGE_BYTES + tfm::SCAN_BYTES, "
          '"codegen_cuda.FLATMAP_SCAN_BYTES");', ""]
    L.append(_body_fn("body", len(spec.reads), _need_cuda_body(spec),
                      counted=True))
    params = [f"const float* __restrict__ in{i}"
              for i in range(len(spec.inputs))]
    params += ["float* __restrict__ buf", "int* __restrict__ count",
               "uint64_t* __restrict__ flags", "unsigned epoch"]
    L.append("__global__ void __launch_bounds__(tcopy::THREADS)\n"
             "flatmap_kernel(" + ", ".join(params) + ") {")
    L += _tiled_buffers(spec, fifo=True)
    L += ["  tfm::Scan* const scan = reinterpret_cast<tfm::Scan*>("
          "smem + CHARGE_BYTES / 4);",
          "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;",
          "  const int lo = warp * SEG;",
          "  const int hi = lo + SEG < TILE_N ? lo + SEG : TILE_N;",
          "  float* const mine = fifo + lo * M;  // this warp's FIFO region"]
    L += _hoisted_c(spec)
    streamed = [k for k, ld in enumerate(spec.loads) if ld.slots > 1]
    ring = [k for k in streamed if spec.loads[k].vec4]
    prologue, top = _ring_c(_flatmap_fill(spec, ring))
    L += prologue
    L += ["  int step = 0;",
          "  for (long long g = blockIdx.x; g < GRID; "
          "g += gridDim.x, ++step) {",
          "    const int slot = step % DEPTH;"]
    gvars = [f"g{j}" for j in range(len(spec.grid))]
    sync = [k for k in streamed if k not in ring]
    if sync:   # copied here: slot step % DEPTH was last read DEPTH steps ago
        L += ["    " + x for x in _unflatten_c("g", spec.grid, "long long")]
        for k in sync:
            L += ["    " + x for x in _copy_c(
                spec, k, f"buf{k} + slot * {spec.loads[k].words}", gvars)]
    L += top
    for k, ld in enumerate(spec.loads):
        L.append(f"    float* const t{k} = buf{k};" if ld.slots == 1 else
                 f"    float* const t{k} = buf{k} + slot * {ld.words};")
    wl, args = _windows_c(spec)
    # (1) each warp runs the body over its segment, UNROLL chunks of 32
    # indices at a time, and compacts what it keeps, in index order, at
    # the front of its own FIFO region (windows clamp into the tile, so
    # indices past the segment run too and keep nothing)
    L += ["    int run = 0;",
          "    for (int chunk = lo; chunk < hi; chunk += 32 * tfm::UNROLL) {",
          "      float v[tfm::UNROLL][M];",
          "      int c[tfm::UNROLL];",
          "#pragma unroll",
          "      for (int u = 0; u < tfm::UNROLL; ++u) {",
          "        const int l = chunk + 32 * u + lane;"]
    L += ["        " + x for x in _unflatten_c("l", spec.domain, "int") + wl]
    L += ["        c[u] = 0;",
          f"        body({', '.join(args + ['v[u]', 'c[u]'])});",
          "        c[u] = l < hi ? tfm::kept(c[u], M) : 0;", "      }",
          "#pragma unroll",
          "      for (int u = 0; u < tfm::UNROLL; ++u) {",
          "        const int at = tfm::place<M>(c[u], run);",
          "#pragma unroll",
          "        for (int j = 0; j < M; ++j)",
          "          if (j < c[u]) mine[at + j] = v[u][j];",
          "      }", "    }",
          "    if (lane == 0) scan->warp_count[warp] = run;",
          "    __syncthreads();",
          # (2) the warp's offset in the tile and the tile's count
          "    int off = 0, tile_n = 0;",
          "    for (int w = 0; w < tfm::WARPS; ++w) {",
          "      const int cw = scan->warp_count[w];",
          "      off += w < warp ? cw : 0;",
          "      tile_n += cw;",
          "    }",
          "    if (threadIdx.x == 0) "
          "tfm::publish_count(flags, g, tile_n, epoch);",
          # (3) the tile's offset by look-back; each warp copies its run out
          "    const int base = "
          "tfm::look_back(flags, g, tile_n, epoch, scan) + off;",
          "#pragma unroll 4",
          "    for (int i = lane; i < run; i += 32) buf[base + i] = mine[i];",
          "  }",
          "  hop::cp_async_wait<0>();",
          "  tfm::tail(buf, count, flags, GRID, CAP, epoch, scan);",
          "}", "}  // namespace", ""]
    L.append(_ctas_source("tfm", "flatmap_kernel", "SMEM_BYTES"))
    n_in = len(spec.inputs)
    decl = "".join(f"  const float* in{i} = (const float*)ins[{i}];\n"
                   for i in range(n_in))
    refs = ", ".join([f"&in{i}" for i in range(n_in)]
                     + ["&b", "&c", "&f", "&epoch"])
    L.append(f'''extern "C" int tfm_launch(void* const* ins, void* buf,
                          void* count, void* flags, unsigned epoch,
                          int ctas, void* stream) {{
{decl}  float* b = (float*)buf;
  int* c = (int*)count;
  uint64_t* f = (uint64_t*)flags;
  void* args[] = {{{refs}}};
  return gflags::launch(flatmap_kernel, ctas, tcopy::THREADS, SMEM_BYTES,
                        (cudaStream_t)stream, args);
}}''')
    return "\n".join(L) + build.ERROR_STRING


class TiledKernel:
    """The kernel of one tiled Map or FlatMap at one plan: its
    ``TiledSpec``, its generated source (made at first use: it needs the
    pattern's CUDA body) and -- from its first launch on a card -- the
    loaded library and its persistent block count."""

    def __init__(self, spec: TiledSpec):
        self.spec = spec
        self._source: Optional[str] = None
        self._lib = None
        self._ctas: Dict[torch.device, int] = {}
        self.flags = Flags()   # the FlatMap's: one word per grid step

    @property
    def name(self) -> str:
        """The build name (``build.load`` / ``build.compile_all``)."""
        return f"tiled_{self.spec.kind}"

    @property
    def source(self) -> str:
        if self._source is None:
            gen = map_source if self.spec.kind == "map" else flatmap_source
            self._source = gen(self.spec)
        return self._source

    def library(self):
        if self._lib is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib = build.load(self.name, self.source)
            if self.spec.kind == "map":
                fns = {"tmap_ctas": [ctypes.POINTER(ci)],
                       "tmap_launch": [vp, vp, ci, vp]}
            else:
                fns = {"tfm_ctas": [ctypes.POINTER(ci)],
                       "tfm_launch": [vp] * 4 + [ctypes.c_uint, ci, vp]}
            self._lib = build.bind(lib, fns)
        return self._lib

    def ctas(self, dev: torch.device) -> int:
        if dev not in self._ctas:
            fn = "tmap_ctas" if self.spec.kind == "map" else "tfm_ctas"
            spec = self.spec
            what = f"tiled {spec.kind}" + (
                f" (charged {spec.onchip_bytes} B + scan {spec.scan_bytes} B)"
                if spec.scan_bytes else "")
            self._ctas[dev] = _persistent_ctas(
                self.library, fn, spec.smem_bytes, dev, what)
        return self._ctas[dev]


# ------------------------------------------------------- plain versions


def _local_index(domain: Tuple[int, ...], dev) -> Tuple[torch.Tensor, ...]:
    rem = torch.arange(_words(domain), device=dev)
    idx = []
    for e in reversed(domain):
        idx.append(rem % e)
        rem = rem // e
    return tuple(reversed(idx))


def _tile_windows(spec: TiledSpec, srcs: List[torch.Tensor],
                  g: Tuple[int, ...], local: Tuple[torch.Tensor, ...]
                  ) -> List[torch.Tensor]:
    """Each read's window at every local index of grid step ``g``,
    gathered from the flat sources by the spec's offsets:
    ``(tile_n,) + window`` with singleton dims squeezed."""
    n = spec.tile_n
    dev = local[0].device
    out = []
    for rd in spec.reads:
        ld = spec.loads[rd.load]
        strides = _row_major(ld.shape)
        off = torch.full((n,), ld.origin + sum(
            s * gi for s, gi in zip(ld.step, g)), device=dev)
        for d, row in enumerate(rd.local):
            start = sum(c * li for c, li in zip(row, local) if c)
            if isinstance(start, torch.Tensor):
                start = start.clamp(0, ld.tile[d] - rd.window[d])
            off = off + start * strides[d]
        win = torch.tensor(
            [sum(c * s for c, s in zip(e, strides))
             for e in itertools.product(*(range(w) for w in rd.window))],
            device=dev)
        kept = tuple(w for w in rd.window if w != 1)
        out.append(srcs[ld.operand][off[:, None] + win].reshape((n,) + kept))
    return out


def _grid(spec: TiledSpec):
    return itertools.product(*(range(g) for g in spec.grid))


def _sources(spec: TiledSpec, tensors: Dict[str, torch.Tensor]):
    srcs = [tensors[name].reshape(-1) for name, _ in spec.inputs]
    return srcs, _local_index(spec.domain, _on(srcs))


def tiled_map_plain(spec: TiledSpec, tensors: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
    """Plain PyTorch version of ``tiled_map``: grid step by grid step,
    the Map's torch body over the whole tile, each window gathered at
    the spec's offsets and the block stored at the spec's output
    offsets."""
    srcs, local = _sources(spec, tensors)
    dev = local[0].device
    n, width = spec.tile_n, spec.width
    elem = tuple(spec.body.elem_shape)
    out = torch.empty(_words(spec.out_shape), dtype=torch.float32,
                      device=dev)
    at = sum(li * s for li, s in zip(local, spec.out_local))[:, None] \
        + torch.arange(width, device=dev)
    for g in _grid(spec):
        v = spec.body.fn(g + local, *_tile_windows(spec, srcs, g, local))
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if tuple(v.shape) != (n,) + elem:
            v = v.expand((n,) + elem)
        o = spec.out_origin + sum(s * gi for s, gi in zip(spec.out_step, g))
        out[o + at] = v.reshape(n, width)
    return out.reshape(spec.out_shape)


def tiled_flatmap_plain(spec: TiledSpec, tensors: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``tiled_flatmap``: grid step by grid
    step, the FlatMap's torch body over the whole tile; the kept values
    (lane < count) in grid, index and lane order, zeros after them, and
    the total count as a 0-d int32 tensor."""
    srcs, local = _sources(spec, tensors)
    dev = local[0].device
    n, m = spec.tile_n, spec.width
    lanes = torch.arange(m, device=dev)
    kept = []
    for g in _grid(spec):
        vals, cnt = spec.body.fn(g + local,
                                 *_tile_windows(spec, srcs, g, local))
        vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        vals = vals.reshape(n, m) if vals.numel() == n * m \
            else vals.expand(n, m)
        cnt = torch.as_tensor(cnt, device=dev).to(torch.int64).expand(n)
        kept.append(vals[lanes[None, :] < cnt[:, None]])
    flat = torch.cat(kept)
    buf = torch.zeros(spec.out_shape, dtype=torch.float32, device=dev)
    buf[:flat.numel()] = flat
    return buf, torch.tensor(flat.numel(), dtype=torch.int32, device=dev)


# ------------------------------------------------------------- wrappers


def _tiled_inputs(spec: TiledSpec, tensors: Dict[str, torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.device]:
    ins = []
    for name, shape in spec.inputs:
        _f32(name, tensors[name], shape)
        ins.append(tensors[name])
    dev = _on(ins)
    if dev.type == "cuda":
        _aligned([(name, tensors[name]) for name, _ in spec.inputs])
    return ins, dev


def tiled_map(kernel: TiledKernel, tensors: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """Run the tiled-Map kernel on ``tensors`` (name -> float32 tensor).

    Replaces the TPU kernel ``lower_tiled_map`` (reference
    codegen_pallas.py).  Bound by main-memory bytes (the output stream):
    persistent blocks stage each grid step's tiles in rotating shared
    slots and write the block's outputs once, neighbouring threads on
    neighbouring words.  CPU tensors take ``tiled_map_plain``; CUDA
    tensors launch the kernel or raise.
    """
    spec = kernel.spec
    ins, dev = _tiled_inputs(spec, tensors)
    if dev.type == "cpu":
        return tiled_map_plain(spec, tensors)
    lib = kernel.library()
    ctas = kernel.ctas(dev)
    out = torch.empty(spec.out_shape, dtype=torch.float32, device=dev)
    ptrs = build.pointers([t.data_ptr() for t in ins])
    rc = lib.tmap_launch(ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
                         ctas, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "tiled_map launch")
    tiled_map.launches += 1
    return out


tiled_map.launches = 0


def tiled_flatmap(kernel: TiledKernel, tensors: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the tiled-FlatMap kernel on ``tensors``; returns ``(buffer,
    count)``: the kept values compacted in grid, index and lane order
    with zeros after them, and their number as a 0-d int32 tensor on
    the device (never read by the host here).

    Replaces the TPU kernel ``lower_tiled_flatmap`` (reference
    codegen_pallas.py), whose running offset crosses grid steps: one
    cooperative launch that reads each tile once through a ``cp.async``
    ring, counts and compacts it in its shared FIFO and finds its offset
    by decoupled look-back over the tiles' flag words
    (``kernel.flags``).  Bound by main-memory bytes.  CPU tensors take
    ``tiled_flatmap_plain``; CUDA tensors launch the kernel or raise.
    """
    spec = kernel.spec
    ins, dev = _tiled_inputs(spec, tensors)
    if dev.type == "cpu":
        return tiled_flatmap_plain(spec, tensors)
    lib = kernel.library()
    ctas = kernel.ctas(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = torch.empty(spec.out_shape, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    flags, epoch = kernel.flags.next(dev, stream, spec.steps)
    ptrs = build.pointers([t.data_ptr() for t in ins])
    rc = lib.tfm_launch(ctypes.cast(ptrs, ctypes.c_void_p), buf.data_ptr(),
                        count.data_ptr(), flags, epoch, ctas, stream)
    build.check(lib, rc, "tiled_flatmap launch")
    tiled_flatmap.launches += 1
    return buf, count


tiled_flatmap.launches = 0


def _lower_tiled(p: ir.Pattern, kind: str, run: Callable, depth: int,
                 device) -> Callable:
    dev = resolve(device)
    spec = tiled_spec(p, depth)
    if spec.kind != kind:
        raise NotImplementedError(f"'{p.name}' is not a tiled {kind}")
    kernel = TiledKernel(spec)
    if dev.type == "cuda":
        _need_cuda_body(spec)

    def call(**tensors):
        ts = {name: _staged(tensors[name], dev) for name, _ in spec.inputs}
        return run(kernel, ts)

    call.kernel = kernel
    return call


def lower_tiled_map(p: ir.MultiFold, *, depth: int = 2,
                    device=None) -> Callable:
    """Tiled Map template (write-once ``MultiFold(grid) {loads;
    Map(tile)}``): one block of outputs per grid step, tiles staged at
    ``depth`` shared slots.  Returns ``call(**tensors) -> tensor`` with
    ``.kernel`` (the ``TiledKernel``)."""
    return _lower_tiled(p, "map", tiled_map, depth, device)


def lower_tiled_flatmap(p: ir.FlatMap, *, depth: int = 2,
                        device=None) -> Callable:
    """Parallel-FIFO template (``FlatMap(grid) {loads; FlatMap(tile)}``).
    Returns ``call(**tensors) -> (buffer, count)`` with ``.kernel``."""
    return _lower_tiled(p, "flatmap", tiled_flatmap, depth, device)


def lower_tiled_groupby(p: ir.GroupByFold, *, depth: int = 2,
                        device=None) -> Callable:
    """CAM template (``GroupByFold(grid) {loads; GroupByFold(tile)}``).

    That tiled IR is a fused DAG of one CAM terminal and no stages, so
    it lowers through the fused-DAG megakernel (``fused_dag.cuh``):
    per-warp tables without atomics, keys outside ``[0, num_keys)``
    dropped, partials summed in block order.  Shapes ``dag_spec`` does not take
    (a non-additive combine, a key read from a pattern) raise
    ``NotImplementedError``."""
    if not (p.strided and isinstance(p.inner, ir.GroupByFold)):
        raise NotImplementedError(f"'{p.name}' is not a tiled GroupByFold")
    return lower_fused_chain(p, depth=depth, device=device)


# --------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------


def lower(p: ir.Pattern, *, device=None, depth: int = 2) -> Callable:
    """Pick the template for a tiled pattern (paper: template
    selection), in the reference's order: the tiled GEMM, the
    write-once tiled Map, the strided GroupByFold (CAM) and the strided
    FlatMap (parallel FIFO).  ``depth`` is the plan's metapipeline
    depth: the shared slots each streamed tile rotates through.
    Anything else -- a strided fold such as sumrows or tpchq6, the
    single-pattern kmeans, a Map whose tile element is a nested fold --
    raises ``NotImplementedError``, as the reference has no template for
    it either."""
    with telemetry.span("codegen.lower", kind=type(p).__name__,
                        pattern=p.name) as sp:
        if match_tiled_gemm(p):
            sp.set(template="gemm")
            return lower_tiled_gemm(p, depth=depth, device=device)
        if isinstance(p, ir.MultiFold) and p.combine is None \
                and isinstance(p.inner, ir.Map):
            sp.set(template="map")
            return lower_tiled_map(p, depth=depth, device=device)
        if isinstance(p, ir.GroupByFold) and p.strided:
            sp.set(template="groupby")
            return lower_tiled_groupby(p, depth=depth, device=device)
        if isinstance(p, ir.FlatMap) and p.strided:
            sp.set(template="flatmap")
            return lower_tiled_flatmap(p, depth=depth, device=device)
        raise NotImplementedError(
            f"no CUDA template for {type(p).__name__} '{p.name}' (strided="
            f"{p.strided}); templates: tiled GEMM, Map, GroupByFold, "
            "FlatMap")


def lower_auto(p: ir.Pattern, *, plan=None,
               vmem_budget: Optional[int] = None, device=None, tier=None,
               cache=None, measure: Optional[str] = None, policy=None,
               options=None) -> Callable:
    """Tile an *untiled* pattern with a DSE-chosen ``TilePlan`` and lower
    it (paper §4 tile-size selection feeding §5 template selection).

    ``plan=None`` runs ``dse.explore`` on the card's tier (or ``tier``)
    within ``vmem_budget`` (default: the tier's on-chip bytes), with
    ``cache``, ``measure="top_k"`` (back the plan with timings on the
    card), ``policy`` (deadlines, quarantine, certification) and
    ``options`` passed through; the tiled IR is lowered at the plan's
    depth, and the plan is exposed on the returned callable as
    ``.tile_plan``.  Where the template has a design space of its own on
    the tier (``dse.template_kernel``: the tiled GEMM on a GPU tier) the
    DSE explores that space, so the plan is one the template takes,
    charged the shared bytes its launch allocates.
    """
    from .cost import device_tier
    from .dse import explore, template_kernel
    from .strip_mine import tile

    dev = resolve(device)
    tier = device_tier(dev) if tier is None else tier
    budget = tier.onchip_bytes if vmem_budget is None else vmem_budget
    with telemetry.span("codegen.lower_auto", kind=type(p).__name__,
                        pattern=p.name):
        if plan is None:
            plan = explore(p, tier=tier, vmem_budget=budget, device=dev,
                           cache=cache, measure=measure, policy=policy,
                           options=options,
                           kernel=template_kernel(p, tier))
        call = lower(tile(p, plan.sizes, vmem_budget_words=budget // 4),
                     device=dev, depth=plan.depth)
    call.tile_plan = plan
    return call


# --------------------------------------------------------------------
# Lowering for the timing harness (the DSE's measured mode)
# --------------------------------------------------------------------


def kernel_sources(call) -> List[Tuple[str, str]]:
    """The ``(build name, source)`` of every translation unit a lowered
    call launches (``lower`` / ``lower_fused_pipeline`` results), for
    ``kernels.build.compile_all``; nothing is built here."""
    if hasattr(call, "group_calls"):
        return [s for g in call.group_calls for s in kernel_sources(g)]
    if hasattr(call, "kernel"):
        return [(call.kernel.name, call.kernel.source)]
    if hasattr(call, "source"):
        return [("tiled_gemm", call.source)]
    return []


def _tile_for_timing(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]],
                     budget: int) -> ir.Pattern:
    from .strip_mine import insert_tile_copies, strip_mine, tile

    try:
        return tile(p, sizes, vmem_budget_words=budget // 4)
    except resilience.EXPECTED_ERRORS:
        # the DSE's own fallback (dse._tile_ir): interchange or stage
        # lifting may not apply
        return insert_tile_copies(strip_mine(p, sizes),
                                  vmem_budget_words=budget // 4)


def _timing_budget(vmem_budget: Optional[int], dev) -> int:
    from .cost import device_tier
    return device_tier(dev).onchip_bytes if vmem_budget is None \
        else vmem_budget


def lower_candidate(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]], *,
                    vmem_budget: Optional[int] = None, device=None,
                    depth: int = 2) -> Callable:
    """One tile-size candidate of an *untiled* pattern tiled and lowered
    through its CUDA template, nothing built or launched: the template's
    spec is made (``tiled_spec`` / ``dag_spec`` / ``match_tiled_gemm``),
    which raises for a shape no template takes.  ``kernel_sources`` of
    the result is what the candidate's timing will build."""
    dev = resolve(device)
    t = _tile_for_timing(p, sizes, _timing_budget(vmem_budget, dev))
    return lower(t, device=dev, depth=depth)


def lower_for_timing(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]], *,
                     vmem_budget: Optional[int] = None, seed: int = 0,
                     device=None, depth: int = 2
                     ) -> Tuple[Callable[[], Any], str]:
    """Lower one tile-size candidate of an *untiled* pattern into a
    zero-arg callable for the timing harness (``core.measure``), over
    inputs synthesized on ``device`` (the card unless the caller names
    another) from the pattern's tensor metadata.

    The CUDA template is taken at the candidate's ``depth``
    (``lower_candidate``); building its spec is the probe (the
    reference traces the kernel abstractly) and raises before any
    build.  On the card a candidate no template takes raises
    ``NotImplementedError``: the eager oracle is never timed there.  On
    the CPU such a candidate falls back, as in the reference, to the
    oracle of the *tiled* IR (``codegen_torch``), labelled
    ``"oracle"``.  Returns ``(fn, how)`` with ``how`` in {"cuda",
    "oracle"}.
    """
    from .codegen_torch import execute
    from .measure import synth_inputs

    dev = resolve(device)
    budget = _timing_budget(vmem_budget, dev)
    tag = f"{type(p).__name__}:{p.name}"
    # chaos hook: REPRO_FAULTS=lower:<p> fails this lowering before any
    # fallback can mask it -- the caller's quarantine path must fire
    resilience.inject("lower", tag)
    with telemetry.span("codegen.lower_for_timing",
                        kind=type(p).__name__, pattern=p.name) as sp:
        inputs = synth_inputs(ir.inputs_of(p), seed=seed, device=dev)
        try:
            kern = lower_candidate(p, sizes, vmem_budget=budget,
                                   device=dev, depth=depth)
            sp.set(how="cuda")
            return (lambda: kern(**inputs)), "cuda"
        except resilience.EXPECTED_ERRORS as e:
            if dev.type == "cuda":
                raise
            resilience.record_once(
                "lower", resilience.classify(e), tag, "fallback",
                f"CUDA template unusable ({e}); the codegen_torch oracle "
                "of the tiled IR times instead")
            t = _tile_for_timing(p, sizes, budget)
            sp.set(how="oracle")
            return (lambda: execute(t, inputs, device=dev)), "oracle"


def lower_pipeline_for_timing(pipe, plan, *,
                              vmem_budget: Optional[int] = None,
                              seed: int = 0, device=None
                              ) -> Callable[[], Any]:
    """Lower one fused-pipeline plan candidate into a zero-arg callable
    over inputs synthesized on ``device``, for the timing harness.  The
    plan is taken as it is (no DSE re-entry), so each shortlisted
    (block, depth) variant times exactly the megakernel it would ship
    as.  On the card a group the template does not take raises
    ``NotImplementedError``; on the CPU it runs the per-stage oracle
    chain, as ``lower_fused_pipeline`` does."""
    from . import pipeline as plmod
    from .measure import synth_inputs

    dev = resolve(device)
    # chaos hook mirroring the single-pattern path
    resilience.inject("lower", f"Pipeline:{pipe.name}")
    with telemetry.span("codegen.lower_pipeline_for_timing",
                        pipeline=pipe.name, block=int(plan.block),
                        depth=int(plan.depth)):
        inputs = synth_inputs(plmod.external_inputs(pipe), seed=seed,
                              device=dev)
        call = lower_fused_pipeline(pipe, plan=plan,
                                    vmem_budget=vmem_budget, device=dev)
    return lambda: call(**inputs)


# --------------------------------------------------------------------
# paged decode (serving): KV append + attention over a request's pages
# --------------------------------------------------------------------

PD_NEG = -1e30                  # the TPU kernel's finite mask value
_PD_TYPES = (torch.float32, torch.bfloat16)   # pools and q the kernel reads

PAGED_DECODE_SOURCE = '''// paged decode: paged_decode.cuh's attend kernel per pool and q type, and
// the split combine
#include "paged_decode.cuh"

extern "C" int paged_decode_launch(
    const void* q, const void* new_k, const void* new_v, void* kpool,
    void* vpool, const void* page_table, const void* seq_lens, void* out,
    float* pm, float* pl, float* pacc, int batch, int hkv, int group, int d,
    int ps, int npm, int n_phys, int heads, int head_mul, int k_off,
    int v_off, float scale, int splits, int pool_bf16, int q_bf16,
    void* stream) {
  using bf16 = __nv_bfloat16;
  using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                         const int*, const int*, float*, float*, float*,
                         float*, int, int, int, int, int, int, int, int, int,
                         int, int, float, int, cudaStream_t);
  const Launch run = pool_bf16 ? (q_bf16 ? &pdec::launch<bf16, bf16>
                                         : &pdec::launch<bf16, float>)
                               : (q_bf16 ? &pdec::launch<float, bf16>
                                         : &pdec::launch<float, float>);
  return run(q, new_k, new_v, kpool, vpool, (const int*)page_table,
             (const int*)seq_lens, (float*)out, pm, pl, pacc, batch, hkv,
             group, d, ps, npm, n_phys, heads, head_mul, k_off, v_off, scale,
             splits, (cudaStream_t)stream);
}

extern "C" int paged_decode_combine(const float* pm, const float* pl,
                                    const float* pacc, void* out,
                                    long long rows, int d, int splits,
                                    void* stream) {
  return splitk::launch_combine<float>(pm, pl, pacc, out, rows, d, splits,
                                       (cudaStream_t)stream);
}

extern "C" int paged_decode_limits(int* limits) {
  limits[0] = pdec::DMAX;
  limits[1] = pdec::GMAX;
  limits[2] = pdec::KC;
  limits[3] = pdec::BMAX;
  return 0;
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
PAGED_DECODE_LIB = build.Library("paged_decode", PAGED_DECODE_SOURCE, {
    "paged_decode_launch": [_VP] * 11 + [_INT] * 11 + [ctypes.c_float]
    + [_INT] * 3 + [_VP],
    "paged_decode_combine": [_VP] * 4 + [ctypes.c_longlong] + [_INT] * 2
    + [_VP],
    "paged_decode_limits": [_VP]})
_pd_limits: List[int] = []
_PD_SMS: Dict[torch.device, int] = {}   # SMs of each card, read once
# pdec's constants for planning off the card (tests/test_torch_paged.py
# holds them to the .cuh; the wrapper asks the library for its limits)
PD_KC = 64                # pdec::KC: keys of a chunk
PD_STAGES = 2             # pdec::STAGES: chunk slots of the ring
PD_GMAX = 16              # pdec::GMAX: query rows of a kv head, at most
PD_DMAX = 128             # pdec::DMAX: head dim, at most
PD_SPLIT_CHUNKS = 16      # a split holds at most this many chunks ...
PD_SPLITS_MAX = 64        # ... and there are at most pdec::SMAX splits


def pd_launch_group(group: int) -> int:
    """The query rows G a block is instantiated for at ``group`` query
    heads per kv head (``pdec::launch``: 4, 8 or GMAX)."""
    if not 1 <= group <= PD_GMAX:
        raise ValueError(f"group {group}: the kernel takes 1..{PD_GMAX}")
    return 4 if group <= 4 else 8 if group <= 8 else PD_GMAX


def pd_smem_bytes(stages: int, kc: int, g: int, d: int, dtype) -> int:
    """A block's shared bytes (``pdec::smem_bytes<T, G>(d)``): the ring of
    ``stages`` x {K, V} x ``kc`` key rows of ``d`` elements of the pool
    type ``dtype`` (a ``torch.dtype`` or its name), then the chunk's
    scores (``kc`` x ``g``) and m, l, alpha (``g`` each) in float32."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in _PD_TYPES:
        raise ValueError(f"paged_decode pools are float32 or bfloat16, got "
                         f"{dtype}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    return stages * 2 * kc * d * itemsize + (g * kc + 3 * g) * 4


# csrc/flash_attention.cuh's constants: keys of a chunk (fa::BC), packed
# rows of an FFMA tile (fa::BR) and the largest head dim (fa::DMAX)
FA_BC = 64
FA_BR = 64
FA_DMAX = 128


def fa_tiles(which: str, rows: int) -> Tuple[int, ...]:
    """The packed-row tiles attention's ``which`` kernel takes for
    ``rows`` packed rows of a kv head: 64 or 128 (two warpgroups) for
    wgmma when there are more than 64 rows, else 64."""
    return (64, 128) if which == "wgmma" and rows > 64 else (64,)


def fa_smem_bytes(which: str, tile_rows: int, d: int) -> int:
    """A block's shared bytes in ``csrc/flash_attention.cuh`` at head dim
    ``d``: for ``"wgmma"`` ``WLayout<DP, NWG>::SMEM`` (DP = 64 or 128,
    NWG = tile_rows / 64: the Q tile, STAGES slots of K and V boxes,
    the ring's mbarriers and 1024 bytes of alignment slack), for
    ``"ffma"`` ``4 * smem_floats(DP)`` (DP the head dim rounded up to
    16: Q and K transposed, V and P)."""
    if which == "wgmma":
        if tile_rows not in (64, 128):
            raise ValueError(f"wgmma tiles are 64 or 128 rows, not "
                             f"{tile_rows}")
        dp = 64 if d <= 64 else 128
        halves, stages = dp // 64, 4 if dp == 64 else 3
        q_bytes = halves * (tile_rows // 64) * 64 * 128
        stage_bytes = 2 * halves * FA_BC * 128
        return q_bytes + stages * stage_bytes + (2 * stages + 1) * 8 + 1024
    if tile_rows != FA_BR:
        raise ValueError(f"ffma tiles are {FA_BR} rows, not {tile_rows}")
    dp = -(-d // 16) * 16
    ts = FA_BR + 4
    return 4 * (2 * dp * ts + FA_BC * dp + FA_BC * ts)


def _pd_refuse(b: int, group: int, dh: int, ps: int, itemsize: int) -> None:
    """Raise ``ValueError`` for a shape past the kernel's limits, which
    the library reports (``pdec::DMAX``, ``GMAX``, ``KC``, ``BMAX``), or
    a head whose rows are not whole 16-byte pieces."""
    if not _pd_limits:
        out = (ctypes.c_int * 4)()
        PAGED_DECODE_LIB("paged_decode_limits", ctypes.addressof(out))
        _pd_limits.extend(out)
    dmax, gmax, kc, bmax = _pd_limits
    if dh > dmax or group > gmax or ps > kc or b > bmax:
        raise ValueError(f"head dim {dh}, group {group}, page size {ps}, "
                         f"{b} requests: the kernel takes at most {dmax}, "
                         f"{gmax}, {kc}, {bmax}")
    if dh * itemsize % 16:
        raise ValueError(f"head dim {dh}: the kernel copies key rows in "
                         f"16-byte pieces ({dh * itemsize} bytes a row)")


def paged_splits(batch: int, kv_heads: int, n_pages_max: int,
                 page_size: int, sms: int) -> int:
    """How many parts the kernel cuts each request's live chunks into
    (grid ``(kv_heads, batch, splits)``), from the static shape only (the
    lengths stay on the card).  The rule of ``flash_attention``'s
    ``launch_plan``: under two (request, kv head) blocks per SM, enough
    parts for four per SM; and no part longer than PD_SPLIT_CHUNKS
    chunks of the longest context the table holds; at most one part per
    chunk of that context and PD_SPLITS_MAX in all."""
    chunks = -(-n_pages_max // (PD_KC // page_size))
    pairs = batch * kv_heads
    fill = -(-4 * sms // pairs) if pairs < 2 * sms else 1
    return max(1, min(chunks, PD_SPLITS_MAX,
                      max(fill, -(-chunks // PD_SPLIT_CHUNKS))))


def pd_split_range(n: int, split: int, splits: int) -> Tuple[int, int]:
    """``(first, end)``: the chunks of part ``split`` of ``splits`` of a
    request's ``n`` live chunks (``splitk::part``)."""
    return split * n // splits, (split + 1) * n // splits


def _pd_heads(layout: str, kv_heads: int):
    """(K pool index, V pool index, heads of a pool row, head multiplier,
    K offset, V offset) of a layout: split pools hold head h at h, the
    fused pool K at 2h and V at 2h + 1."""
    if layout == "fused":
        return 0, 0, 2 * kv_heads, 2, 0, 1
    return 0, 1, kv_heads, 1, 0, 0


def paged_decode_plain(q: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, pools: Sequence[torch.Tensor],
                       page_table: torch.Tensor, seq_lens: torch.Tensor, *,
                       layout: str = "split", pages_per_step: int = 1,
                       splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the paged-decode kernel, step for step
    as the TPU kernel does it, every (request, kv head, query row) at
    once: the append into ``pools`` (in place), then the online softmax
    over all ``n_pages_max`` pages, page by page, in float32 (masked
    positions -1e30, page ids clipped into the pool, p not rounded).
    ``splits`` > 1 is the kernel's flash-decoding: each request's live
    chunks of PD_KC keys are cut into that many parts
    (``pd_split_range``), each part keeps its own (m, l, acc) over its
    pages, and the parts are merged in split order as the combine kernel
    merges them.  Returns the float32 output ``(B, Hkv, group, dh)``."""
    b, hkv, group, dh = q.shape
    npm = page_table.shape[1]
    if npm % pages_per_step:
        raise ValueError(f"pages_per_step {pages_per_step} must divide the "
                         f"static page bound {npm}")
    ki, vi, _, mul, k_off, v_off = _pd_heads(layout, hkv)
    kpool, vpool = pools[ki], pools[vi]
    n_phys, ps = kpool.shape[0], kpool.shape[1]
    dev = q.device
    rows = torch.arange(b, device=dev)
    kh = torch.arange(hkv, device=dev) * mul + k_off
    vh = torch.arange(hkv, device=dev) * mul + v_off
    lens = seq_lens.long()
    page_table = page_table.long()
    # the append: lax.dynamic_update_slice clamps an index past the table
    # or the pool, and so does this
    page = page_table[rows, (lens // ps).clamp(0, npm - 1)]
    page = page.clamp(0, n_phys - 1)
    slot = lens % ps
    kpool[page[:, None], slot[:, None], kh[None, :]] = new_k.to(kpool.dtype)
    vpool[page[:, None], slot[:, None], vh[None, :]] = new_v.to(vpool.dtype)

    # each request's pages of each part: [lo, hi) (splits, B)
    ppc = PD_KC // ps
    live = (lens // ps).clamp(0, npm - 1) + 1
    chunks = (live + ppc - 1) // ppc
    part = torch.arange(splits, device=dev)[:, None]
    lo = part * chunks[None] // splits * ppc
    hi = (part + 1) * chunks[None] // splits * ppc

    qf = q.float()
    scale = dh ** -0.5
    m = torch.full((splits, b, hkv, group), PD_NEG, device=dev)
    el = torch.zeros((splits, b, hkv, group), device=dev)
    acc = torch.zeros((splits, b, hkv, group, dh), device=dev)
    for p in range(npm):
        pid = page_table[:, p].clamp(0, n_phys - 1)
        kpg = kpool[pid][:, :, kh].float().transpose(1, 2)  # (B,Hkv,ps,dh)
        vpg = vpool[pid][:, :, vh].float().transpose(1, 2)
        s = (qf @ kpg.transpose(-1, -2)) * scale              # (B, Hkv, g, ps)
        pos = p * ps + torch.arange(ps, device=dev)
        seen = pos[None, :] <= lens[:, None]                  # (B, ps)
        if splits > 1:
            seen = seen & ((lo <= p) & (p < hi))[..., None]   # (S, B, ps)
        s = torch.where(seen[..., None, None, :], s, PD_NEG)
        m_new = torch.maximum(m, s.amax(-1))
        pexp = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        el = el * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + pexp @ vpg
        m = m_new
    if splits == 1:
        return acc[0] / el[0][..., None]
    mx = m.amax(0)
    l_sum = torch.zeros_like(mx)
    a_sum = torch.zeros_like(acc[0])
    for i in range(splits):                                  # in split order
        w = torch.exp(m[i] - mx)
        l_sum = l_sum + el[i] * w
        a_sum = a_sum + acc[i] * w[..., None]
    return a_sum / l_sum[..., None]


def _pd_check(q, new_k, new_v, pools, page_table, seq_lens, *, batch: int,
              kv_heads: int, group: int, head_dim: int, page_size: int,
              n_pages_max: int, layout: str):
    want = {"q": (batch, kv_heads, group, head_dim),
            "new_k": (batch, kv_heads, head_dim),
            "new_v": (batch, kv_heads, head_dim),
            "page_table": (batch, n_pages_max), "seq_lens": (batch,)}
    for name, t in (("q", q), ("new_k", new_k), ("new_v", new_v),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"'{name}' has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    heads = 2 * kv_heads if layout == "fused" else kv_heads
    n_pools = 1 if layout == "fused" else 2
    if len(pools) != n_pools:
        raise ValueError(f"layout {layout!r} takes {n_pools} pools, got "
                         f"{len(pools)}")
    for t in pools:
        if t.dim() != 4 or tuple(t.shape[1:]) != (page_size, heads,
                                                  head_dim) \
                or t.dtype != pools[0].dtype or t.shape != pools[0].shape:
            raise ValueError(f"pool {t.dtype} {tuple(t.shape)}: expected "
                             f"(P, {page_size}, {heads}, {head_dim}), "
                             "one type")
    if page_table.is_floating_point() or seq_lens.is_floating_point():
        raise ValueError("page_table and seq_lens must be integers")


def paged_decode(q, new_k, new_v, pools, page_table, seq_lens, *,
                 layout: str = "split") -> torch.Tensor:
    """Launch the paged-decode kernel on CUDA tensors (shapes checked by
    the caller): the pools are updated in place; returns the float32
    output.  The attend kernel runs on a grid of (kv head, request,
    ``paged_splits``) blocks; with more than one split the combine
    kernel merges their partials (one ``torch.empty`` holds them).
    Counts ``lower_paged_decode.attend_launches`` and
    ``.combine_launches``.  Raises for what the kernel does not take."""
    b, hkv, group, dh = q.shape
    kpool = pools[0]
    n_phys, ps = kpool.shape[0], kpool.shape[1]
    npm = page_table.shape[1]
    if kpool.dtype not in _PD_TYPES:
        raise ValueError(f"paged_decode pools are float32 or bfloat16, got "
                         f"{kpool.dtype}")
    _pd_refuse(b, group, dh, ps, kpool.element_size())
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("paged_decode updates contiguous pools in place")
    _aligned([(f"pool {i}", t) for i, t in enumerate(pools)])
    if q.dtype not in _PD_TYPES:
        q = q.float()
    q = q.contiguous()
    # no copies on the serving path: new K/V come in the pools' type and
    # PagedKVCache keeps page_table and seq_lens int32
    new_k = build.aligned(new_k.to(kpool.dtype).contiguous())
    new_v = build.aligned(new_v.to(kpool.dtype).contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    ki, vi, heads, mul, k_off, v_off = _pd_heads(layout, hkv)
    if q.device not in _PD_SMS:
        _PD_SMS[q.device] = torch.cuda.get_device_properties(
            q.device).multi_processor_count
    splits = paged_splits(b, hkv, npm, ps, _PD_SMS[q.device])
    rows = b * hkv * group
    out = torch.empty((b, hkv, group, dh), dtype=torch.float32,
                      device=q.device)
    parts = [0, 0, 0]
    if splits > 1:
        buf = torch.empty(splits * rows * (dh + 2), dtype=torch.float32,
                          device=q.device)
        base = buf.data_ptr()
        parts = [base, base + splits * rows * 4, base + 2 * splits * rows * 4]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    PAGED_DECODE_LIB(
        "paged_decode_launch", q.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), pools[ki].data_ptr(), pools[vi].data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), *parts,
        b, hkv, group, dh, ps, npm, n_phys, heads, mul, k_off, v_off,
        float(dh ** -0.5), splits, int(kpool.dtype == torch.bfloat16),
        int(q.dtype == torch.bfloat16), stream)
    lower_paged_decode.attend_launches += 1
    if splits > 1:
        PAGED_DECODE_LIB("paged_decode_combine", *parts, out.data_ptr(),
                         rows, dh, splits, stream)
        lower_paged_decode.combine_launches += 1
    return out


def lower_paged_decode(*, batch: int, kv_heads: int, group: int,
                       head_dim: int, page_size: int, n_pages_max: int,
                       layout: str = "split",
                       pages_per_step: int = 1) -> Callable:
    """The fused decode kernel over a paged KV cache
    (``csrc/paged_decode.cuh``): the KV-append producer writes the step's
    token into its page slot, then the attention fold streams the
    request's pages with an online softmax.  The streaming domain is
    ragged (``ir.RaggedExtent``): positions past ``seq_lens`` are masked
    to -1e30, so the result does not depend on what the unallocated tail
    of the page table points at.

    Layouts: ``split`` takes two pools ``(P, ps, Hkv, dh)``, ``fused``
    one head-interleaved pool ``(P, ps, 2 Hkv, dh)`` (K at head 2h, V at
    2h + 1).  ``pages_per_step`` (the TPU kernel's grid step) must
    divide ``n_pages_max``; the CUDA kernel stages 64 keys at a time
    whatever it is, and splits each request's live chunks across
    ``paged_splits`` blocks.

    Returns ``call(q, new_k, new_v, pools, page_table, seq_lens) ->
    (out, pools)``: ``q`` ``(B, Hkv, group, dh)``, ``new_k`` / ``new_v``
    ``(B, Hkv, dh)`` (already rotated; cast to the pools' type), ``out``
    the float32 ``(B, Hkv, group, dh)`` output.  The pools are updated in
    place and returned (the TPU kernel returns new ones).  CUDA tensors
    launch the kernels (``lower_paged_decode.launches`` counts calls,
    ``.attend_launches`` and ``.combine_launches`` each kernel's
    launches, ``paged_decode``); CPU tensors take ``paged_decode_plain``.
    """
    with telemetry.span("codegen.lower_paged_decode", layout=layout,
                        page_size=page_size, batch=batch):
        if layout not in PAGED_LAYOUTS:
            raise ValueError(f"layout {layout!r}; one of {PAGED_LAYOUTS}")
        if n_pages_max % pages_per_step:
            raise ValueError(
                f"pages_per_step {pages_per_step} must divide the static "
                f"page bound {n_pages_max}")
    dims = dict(batch=batch, kv_heads=kv_heads, group=group,
                head_dim=head_dim, page_size=page_size,
                n_pages_max=n_pages_max, layout=layout)

    def call(q, new_k, new_v, pools, page_table, seq_lens):
        pools = tuple(pools)
        dev = _on([q, new_k, new_v, *pools, page_table, seq_lens])
        _pd_check(q, new_k, new_v, pools, page_table, seq_lens, **dims)
        if dev.type == "cpu":
            out = paged_decode_plain(q, new_k, new_v, pools, page_table,
                                     seq_lens, layout=layout,
                                     pages_per_step=pages_per_step)
            return out, pools
        out = paged_decode(q, new_k, new_v, pools, page_table, seq_lens,
                           layout=layout)
        lower_paged_decode.launches += 1
        return out, pools

    return call


lower_paged_decode.launches = 0          # calls on CUDA tensors
lower_paged_decode.attend_launches = 0   # of the attend kernel
lower_paged_decode.combine_launches = 0  # of the split combine
