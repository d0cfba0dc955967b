"""Hardware generation: lower tiled PPL IR to hand-written CUDA templates.

This is the paper's §5 code generation step with CUDA templates in the
place of MaxJ ones, for an NVIDIA Hopper card (``sm_90a``):

  * the tiled GEMM (Table 3 form)          -> ``csrc/tiled_gemm.cuh``,
    one block per output tile looping over K itself
  * a fused pipeline DAG (``lower_fused_dag``) -> ``csrc/fused_dag.cuh``,
    one persistent multi-output megakernel: producer stages in
    shared-memory scratch, fold terminals in registers, CAM terminals in
    a per-block shared table, Map terminals streamed out once; per-block
    partials are summed by a second small launch

The generator instantiates a template per DAG and plan: it splices each
pattern's CUDA body (``ir.Pattern.cuda``) and the plan's constants into
one translation unit, which ``kernels.build`` compiles with nvcc and
caches by hash.  Every kernel has a wrapper that launches it for CUDA
tensors (or raises), a plain PyTorch version of the same function that
the wrapper takes for CPU tensors only, and a launch count.

Templates for tiled Map, GroupByFold and FlatMap programs
(``lower_tiled_map`` / ``_groupby`` / ``_flatmap`` in the reference)
are not ported yet; ``lower`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir
from .affine import AffineMap
from ..device import resolve
from ..kernels import build


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


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_ERROR_STRING = '''
extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
'''


# --------------------------------------------------------------------
# Tiled GEMM (Table 3 interchanged form):
#   MultiFold(gi,gj) write-once { MultiFold(kk) fold { Map(bi,bj){fold} } }
# --------------------------------------------------------------------


def match_tiled_gemm(p: ir.Pattern) -> bool:
    return (isinstance(p, ir.MultiFold) and p.strided and p.combine is None
            and isinstance(p.inner, ir.MultiFold) and p.inner.strided
            and p.inner.is_fold and isinstance(p.inner.inner, ir.Map))


def gemm_source(bm: int, bn: int, bk: int) -> str:
    """The translation unit instantiating the GEMM template at a tile."""
    return f'''// tiled GEMM at tile ({bm}, {bn}, {bk}), generated by codegen_cuda
#include "tiled_gemm.cuh"

extern "C" int gemm_launch(const void* x, const void* y, void* out, int m,
                           int n, int k, void* stream) {{
  return tgemm::launch<{bm}, {bn}, {bk}>(
      (const float*)x, (const float*)y, (float*)out, m, n, k,
      (cudaStream_t)stream);
}}
''' + _ERROR_STRING


_GEMM_LIBS: Dict[Tuple[int, int, int], Any] = {}


def _gemm_library(bm: int, bn: int, bk: int):
    if (bm, bn, bk) in _GEMM_LIBS:
        return _GEMM_LIBS[(bm, bn, bk)]
    lib = build.load("tiled_gemm", gemm_source(bm, bn, bk))
    lib.gemm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.gemm_launch.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _GEMM_LIBS[(bm, bn, bk)] = lib
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
               bk: int) -> torch.Tensor:
    """``x @ y`` in float32 through the tiled-GEMM kernel at tile
    ``(bm, bn, bk)``.

    Replaces the TPU kernel ``lower_tiled_gemm`` (reference
    codegen_pallas.py).  Bound by fp32 operations on the card (no TF32:
    parity is held at the f32 tolerance); each block owns one output
    tile and loops over K itself, so no output is revisited.  CPU
    tensors take ``tiled_gemm_plain``; CUDA tensors launch the kernel
    or raise.
    """
    m, k = x.shape
    n = y.shape[1]
    _f32("x", x, (m, k))
    _f32("y", y, (k, n))
    if m % bm or n % bn or k % bk:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) must divide ({m}, {n}, {k})")
    if _on((x, y)).type == "cpu":
        return tiled_gemm_plain(x, y, bm=bm, bn=bn, bk=bk)
    if k % 4 or n % 4 or bk % 4 or (bm // 4) * (bn // 4) > 1024:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) on ({m}, {n}, {k}) is "
                         "not one the CUDA template takes")
    lib = _gemm_library(bm, bn, bk)
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    rc = lib.gemm_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                         torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, rc, "tiled_gemm launch")
    tiled_gemm.launches += 1
    return out


tiled_gemm.launches = 0


def lower_tiled_gemm(p: ir.MultiFold, *, device=None) -> Callable:
    """GEMM template: the interchanged tiled IR's inner Map{fold} is a
    tile product accumulated over the strided K fold.  Returns
    ``call(**tensors)`` with ``.tile_plan`` (the tile sizes the IR
    carries)."""
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
        x = torch.as_tensor(tensors[x_tc.src.name]).to(dev).contiguous()
        y = torch.as_tensor(tensors[y_tc.src.name]).to(dev).contiguous()
        return tiled_gemm(x, y, bm=bi, bn=bj, bk=bk)

    call.tile_plan = {p.name: (bi, bj), f.name: (bk,)}
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

    @property
    def onchip_bytes(self) -> int:
        return 4 * sum(b.words * b.slots for b in self.buffers)

    @property
    def smem_bytes(self) -> int:
        # the epilogue's block reduction reuses the first 32 words
        return max(self.onchip_bytes, 4 * 32)


def _probe(index_map, n_in: int) -> AffineMap:
    if isinstance(index_map, AffineMap):
        return index_map
    return AffineMap.probe(index_map, n_in)


def _additive(p: ir.Pattern) -> bool:
    return p.combine is operator.add


def _zero_identity(p: ir.Pattern) -> bool:
    return not bool(torch.as_tensor(p.init()).any())


def dag_spec(terminals, grid_n: int, depth: int = 2) -> DagSpec:
    """Analyse a fused DAG (``pipeline.fuse_dag`` terminals) into the
    megakernel's buffers, stages and terminals.  Raises
    ``NotImplementedError`` for shapes the template does not take."""
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

    # streamed tiles first (16-byte aligned), then stages, preloads, CAMs
    order = {"stream": 0, "stage": 1, "hoisted": 2, "cam": 3}
    perm = sorted(range(len(buffers)), key=lambda i: (order[buffers[i].kind], i))
    remap = {old: new for new, old in enumerate(perm)}

    def fix(reads):
        return tuple(dataclasses.replace(r, buffer=remap[r.buffer])
                     for r in reads)

    return DagSpec(
        block=int(block), grid=int(grid_n), depth=int(depth),
        inputs=tuple(inputs),
        buffers=tuple(buffers[i] for i in perm),
        stages=tuple(dataclasses.replace(s, reads=fix(s.reads),
                                         out=remap[s.out]) for s in stages),
        terminals=tuple(dataclasses.replace(
            t, reads=fix(t.reads),
            table=remap[t.table] if t.table >= 0 else -1) for t in terms),
        partial_words=partial)


# ------------------------------------------------------ source emission


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _body_fn(fname: str, n_reads: int, body: str, keyed: bool) -> str:
    params = [f"const float* __restrict__ in{j}" for j in range(n_reads)]
    params.append("float* __restrict__ out")
    if keyed:
        params.append("int& key")
    text = "\n".join("  " + line for line in body.strip().splitlines())
    return (f"__device__ __forceinline__ void {fname}(\n    "
            + ",\n    ".join(params) + ") {\n" + text + "\n}\n")


def dag_source(spec: DagSpec) -> str:
    """The translation unit of one fused DAG at one plan: the template
    ``fused_dag.cuh`` instantiated with the pattern bodies and the
    plan's constants.  Deterministic for a given DAG and plan."""
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
        f"constexpr int SMEM_BYTES = {spec.smem_bytes};",
        f"constexpr int PARTIAL_WORDS = {spec.partial_words};", ""]
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
    L.append("__global__ void __launch_bounds__(fdag::THREADS)\n"
             "fused_dag_kernel(" + ", ".join(params) + ") {")
    L.append("  extern __shared__ float4 smem4[];")
    L.append("  float* const smem = reinterpret_cast<float*>(smem4);")
    for i, (buf, o) in enumerate(zip(spec.buffers, offsets)):
        L.append(f"  float* const buf{i} = smem + {o};  // {buf.kind} "
                 f"{buf.label}: {buf.slots} x {buf.words} words")
    # per-block set-up: preloads and zeroed CAM tables
    for i, buf in enumerate(spec.buffers):
        if buf.kind == "hoisted":
            src = f"in_{_ident(spec.inputs[buf.operand][0])}"
            L.append(f"  fdag::copy_small(buf{i}, {src}, {buf.words});")
        elif buf.kind == "cam":
            L.append(f"  fdag::zero(buf{i}, {buf.words});")
    for t in spec.terminals:
        if t.kind == "fold":
            L.append(f"  float acc_{_ident(t.name)}[{t.width}] = {{}};")
    L.append("  __syncthreads();")
    L.append("  int step = 0;")
    L.append("  for (long long g = blockIdx.x; g < GRID; "
             "g += gridDim.x, ++step) {")
    L.append("    const int slot = step % DEPTH;")
    for i, buf in enumerate(spec.buffers):
        if buf.kind in ("stream", "stage"):
            L.append(f"    float* const s{i} = buf{i} + slot * {buf.words};")
    for i, buf in enumerate(spec.buffers):
        if buf.kind == "stream":
            src = f"in_{_ident(spec.inputs[buf.operand][0])}"
            L.append(f"    fdag::copy_tile(s{i}, {src} + g * "
                     f"{buf.words}LL, {buf.words});")
    L.append("    __syncthreads();")

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
        fn = f"body_{_ident(t.name)}"
        L.append(f"    // terminal {t.name} ({t.kind})")
        L.append(row_loop + " {")
        if t.kind == "fold":
            L.append(f"      float v[{t.width}];")
            L.append(f"      {fn}({', '.join(args(t.reads) + ['v'])});")
            L.append(f"      for (int j = 0; j < {t.width}; ++j) "
                     f"acc_{_ident(t.name)}[j] += v[j];")
        elif t.kind == "cam":
            L.append(f"      float v[{t.width}];")
            L.append("      int key = -1;")
            L.append(f"      {fn}({', '.join(args(t.reads) + ['v', 'key'])});")
            L.append(f"      fdag::cam_add(buf{t.table}, key, {t.keys}, v, "
                     f"{t.width});")
        else:
            dst = f"out_{_ident(t.name)} + (g * BLOCK + r) * {t.width}LL"
            L.append(f"      {fn}({', '.join(args(t.reads) + [dst])});")
        L.append("    }")
    L.append("  }")
    # epilogue: one partial per block for every fold and CAM terminal
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
    L.append("}")
    L.append("}  // namespace")
    L.append("")
    n_in = len(spec.inputs)
    call = [f"(const float*)ins[{i}]" for i in range(n_in)]
    call += [f"(float*)outs[{i}]" for i in range(n_map)]
    call.append("(float*)partials")
    L.append(f'''extern "C" int fdag_ctas(int* ctas) {{
  cudaError_t e = cudaFuncSetAttribute(
      fused_dag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_dag_kernel, fdag::THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (per_sm > fdag::MAX_CTAS_PER_SM) per_sm = fdag::MAX_CTAS_PER_SM;
  long long n = (long long)sms * per_sm;
  *ctas = (int)(n < GRID ? n : GRID);
  return 0;
}}

extern "C" int fdag_launch(void* const* ins, void* const* outs,
                           void* partials, int ctas, void* stream) {{
  fused_dag_kernel<<<ctas, fdag::THREADS, SMEM_BYTES,
                     (cudaStream_t)stream>>>(
      {", ".join(call)});
  return (int)cudaGetLastError();
}}

extern "C" int fdag_combine(const void* partials, const void* init,
                            void* out, int ctas, void* stream) {{
  if (PARTIAL_WORDS == 0) return 0;
  fdag::combine_partials<<<(PARTIAL_WORDS + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(
      (const float*)partials, (const float*)init, (float*)out, ctas,
      PARTIAL_WORDS);
  return (int)cudaGetLastError();
}}''')
    return "\n".join(L) + _ERROR_STRING


class DagKernel:
    """The megakernel of one fused DAG at one plan: its ``DagSpec``, its
    generated source and -- from its first launch on a card -- the
    loaded library, its persistent block count and the terminals'
    ``init`` words, kept so a launch does no host work beyond it."""

    def __init__(self, spec: DagSpec):
        self.spec = spec
        self.source = dag_source(spec)
        self._lib = None
        self._ctas: Dict[torch.device, int] = {}
        self._init: Dict[torch.device, torch.Tensor] = {}

    def library(self):
        if self._lib is None:
            lib = build.load("fused_dag", self.source)
            vp = ctypes.c_void_p
            lib.fdag_ctas.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.fdag_launch.argtypes = [vp, vp, vp, ctypes.c_int, vp]
            lib.fdag_combine.argtypes = [vp, vp, vp, ctypes.c_int, vp]
            for fn in (lib.fdag_ctas, lib.fdag_launch, lib.fdag_combine):
                fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def ctas(self, dev: torch.device) -> int:
        """Persistent blocks: a few per SM as occupancy allows, at most
        one per grid step.  Raises if the card's shared memory per block
        is smaller than the plan's."""
        if dev not in self._ctas:
            props = torch.cuda.get_device_properties(dev)
            if self.spec.smem_bytes > props.shared_memory_per_block_optin:
                raise ValueError(
                    f"fused DAG needs {self.spec.smem_bytes} B of shared "
                    f"memory; the card allows "
                    f"{props.shared_memory_per_block_optin} B per block")
            lib = self.library()
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _check(lib, lib.fdag_ctas(ctypes.byref(n)),
                       "fused_dag occupancy")
            self._ctas[dev] = n.value
        return self._ctas[dev]

    def init(self, dev: torch.device) -> torch.Tensor:
        """Each fold / CAM terminal's ``init``, flat in partial order."""
        if dev not in self._init:
            parts = [torch.as_tensor(t.outer.init(),
                                     dtype=torch.float32).reshape(-1)
                     for t in self.spec.terminals if t.kind != "map"]
            self._init[dev] = torch.cat(parts).to(dev) if parts \
                else torch.zeros(0, device=dev)
        return self._init[dev]


def fused_dag_plain(spec: DagSpec, tensors: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of ``fused_dag``: the same DAG vectorised
    over the whole streaming domain, applying the patterns' torch
    bodies -- producers as whole-domain tensors, folds as sums of the
    per-index contributions, keyed folds by ``index_add_`` with keys
    outside ``[0, num_keys)`` dropped, Map terminals as whole outputs.
    Folds and keyed folds accumulate in float64 and return float32, so
    the plain version's own rounding stays far below the kernel's."""
    n = spec.grid * spec.block
    dev = _on([tensors[name] for name, _ in spec.inputs])
    i = torch.arange(n, device=dev)
    stack = (i // spec.block, i % spec.block)
    vals: Dict[int, torch.Tensor] = {}
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
        if t.kind == "fold":
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
    once, intermediates stay in shared memory, and each persistent
    block writes one partial per fold / CAM terminal that a second
    launch sums in block order.  CPU tensors take ``fused_dag_plain``;
    CUDA tensors launch the kernel or raise.
    """
    spec = kernel.spec
    ins = []
    for name, shape in spec.inputs:
        _f32(name, tensors[name], shape)
        ins.append(tensors[name])
    dev = _on(ins)
    if dev.type == "cpu":
        return fused_dag_plain(spec, tensors)
    lib = kernel.library()
    ctas = kernel.ctas(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    maps = {t.name: torch.empty(t.shape, dtype=torch.float32, device=dev)
            for t in spec.terminals if t.kind == "map"}
    partials = torch.empty((ctas, max(spec.partial_words, 1)),
                           dtype=torch.float32, device=dev)
    in_ptrs = build.pointers([t.data_ptr() for t in ins])
    out_ptrs = build.pointers([m.data_ptr() for m in maps.values()])
    rc = lib.fdag_launch(ctypes.cast(in_ptrs, ctypes.c_void_p),
                         ctypes.cast(out_ptrs, ctypes.c_void_p),
                         partials.data_ptr(), ctas, stream)
    _check(lib, rc, "fused_dag launch")
    fused_dag.launches += 1
    outs: Dict[str, torch.Tensor] = dict(maps)
    if spec.partial_words:
        flat = torch.empty(spec.partial_words, dtype=torch.float32,
                           device=dev)
        rc = lib.fdag_combine(partials.data_ptr(), kernel.init(dev).data_ptr(),
                              flat.data_ptr(), ctas, stream)
        _check(lib, rc, "fused_dag combine")
        for t in spec.terminals:
            if t.kind != "map":
                w = int(np.prod(t.shape)) if t.shape else 1
                outs[t.name] = flat[t.partial:t.partial + w].reshape(t.shape)
    return {t.name: outs[t.name] for t in spec.terminals}


fused_dag.launches = 0


def lower_fused_dag(terminals, grid_n: int, depth: int = 2, *,
                    device=None) -> Callable:
    """ONE CUDA kernel for a fused pipeline DAG.

    ``terminals`` is a sequence of ``(output name, fused pattern)``
    pairs (``pipeline.fuse_dag`` output) sharing the 1-D strided grid
    ``grid_n``.  External tensors stream through ``depth``-slot shared
    tiles (one per distinct tile, however many terminal trees read it);
    every producer stage runs once per grid step into its ``depth``-slot
    scratch and is consumed in place by all its readers; each terminal
    folds, scatters into its CAM table, or streams its Map block out.
    Main memory is touched solely at the pipeline edges (paper Fig. 6).
    Returns ``call(**tensors) -> {name: tensor}`` with ``.kernel`` (the
    ``DagKernel``: its spec and generated source).
    """
    kernel = DagKernel(dag_spec(terminals, grid_n, depth))
    dev = resolve(device)

    def call(**tensors):
        ts = {name: torch.as_tensor(tensors[name]).to(dev).contiguous()
              for name, _ in kernel.spec.inputs}
        return fused_dag(kernel, ts)

    call.kernel = kernel
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
                         tier=None, **tuning) -> Callable:
    """Lower a ``pipeline.Pipeline`` (DAG) with a joint-DSE
    ``PipelinePlan``.

    ``plan=None`` runs ``dse.explore_pipeline`` on the card's tier (or
    ``tier``).  Each plan group lowers as one multi-output megakernel
    (``lower_fused_dag``) at its own block size and depth; group
    boundaries -- present only on the split-fallback path -- materialize
    their cut intermediates and chain through them.  A group whose
    shape the template does not take runs the per-stage oracle chain on
    the CPU; on the card it raises ``NotImplementedError`` naming the
    group, so no group runs plain PyTorch on CUDA tensors.  The plan is
    exposed on the returned callable as ``.pipeline_plan``,
    ``.group_lowerings`` records what each group compiled to
    (``megakernel`` / ``oracle-chain``) and ``.group_calls`` holds the
    per-group callables (a megakernel's carries its ``DagKernel``).
    Multi-output pipelines return a name -> tensor dict.
    """
    from . import pipeline as plmod
    from .cost import device_tier
    from .dse import _refuse_tuning_runtime, explore_pipeline

    _refuse_tuning_runtime(tuning)
    dev = resolve(device)
    tier = device_tier(dev) if tier is None else tier
    budget = tier.onchip_bytes if vmem_budget is None else vmem_budget
    if plan is None:
        plan = explore_pipeline(pipe, tier=tier, vmem_budget=budget)

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

    def call(**tensors):
        env = {k: torch.as_tensor(v).to(dev) for k, v in tensors.items()}
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
# dispatch
# --------------------------------------------------------------------


def lower(p: ir.Pattern, *, device=None) -> Callable:
    """Pick the template for a tiled pattern (paper: template selection).
    Only the GEMM template is ported; the tiled Map, GroupByFold and
    FlatMap templates raise ``NotImplementedError``."""
    if match_tiled_gemm(p):
        return lower_tiled_gemm(p, device=device)
    raise NotImplementedError(
        f"no CUDA template for {type(p).__name__} (strided={p.strided}) in "
        "this port yet; ported: the tiled GEMM and fused pipeline DAGs")
