"""Fused k-means step megakernel (the paper's Fig. 4/5 DAG, one kernel).

The assign -> {scatter-sum, count} DAG as ONE kernel with two outputs:
each lane computes its point's nearest centroid and keeps it in its
registers beside the point, and both terminals read it there: the
per-centroid coordinate sums and the counts, in register accumulators
without atomics.  Points stream through a ``depth``-slot ``cp.async``
ring; the centroids are copied into shared memory once per block (the
Pipe-0 preload).  It is ``csrc/fused_kmeans.cuh`` for CUDA tensors, one
library per ``(k, d, block_n, depth, lanes)`` (``source``), and the
plain PyTorch version ``fused_kmeans_plain`` for CPU tensors; the
compiler generates the same function from
``patterns.analytics.kmeans_pipeline`` (``codegen_cuda.fused_dag``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import build
from ..core.codegen_cuda import DAG_WARPS, cam_struct_c, piece_words
from ..device import place
from ..patterns.analytics import sq_dist

# registers a lane gives its point's d values and its sum and count
# accumulators (the kernel runs one 256-thread block per SM, up to 255
# registers a thread; the rest hold addresses, distances and the walk)
KM_REG_WORDS = 160
LANE_CHOICES = (1, 2, 4, 8, 16, 32)


def kmeans_lanes(k: int, d: int) -> int:
    """The column slots P of the sums' table (fused_dag.cuh's CAM): the
    smallest P whose ``k * ceil(d / P)`` sum accumulators, ``k`` counts
    and the point's ``d`` values fit KM_REG_WORDS registers a lane.  P = 1
    adds each lane's own point (no exchange); a larger P passes points to
    their owner lanes through a per-warp staging.  Raises ``ValueError``
    when no P fits (the counts alone take ``k``)."""
    for p in LANE_CHOICES:
        if k * -(-d // p) + k + d <= KM_REG_WORDS:
            return p
    raise ValueError(f"fused_kmeans: {k} centroids of {d} values need more "
                     f"than {KM_REG_WORDS} registers a lane at every "
                     f"column split {LANE_CHOICES}")


def swizzle(d: int, r: int) -> int:
    """``fkm::swizzle<d>(r)``: the 16-byte chunk q of row r lies at chunk
    ``q ^ swizzle(d, r)`` of the row in the ring.  With C = d / 4 chunks
    a row, 8 consecutive rows start in ``8 / gcd(C, 8)`` distinct bank
    groups; the XOR spreads them over all 8 (no swizzle for odd C or rows
    that are not whole chunks)."""
    c = d // 4
    if d % 4 or c % 2:
        return 0
    if c % 4 == 2:
        return (r >> 2) & 1
    if c % 8 == 4:
        return (r >> 1) & 3
    return r & 7


@dataclasses.dataclass(frozen=True)
class Layout:
    """A block's shared memory (``fkm::Layout``), each part rounded up to
    16 bytes: the ring of ``depth`` point tiles, the centroids, the block
    table (sums, then counts) and the warps' CAM staging."""

    lanes: int        # column slots P of the sums
    vec: bool         # 16-byte rows: 16-byte cp.async, swizzled chunks
    ring_bytes: int
    stage_bytes: int
    smem_bytes: int


def _r4(words: int) -> int:
    return -(-words // 4) * 4


def layout(k: int, d: int, block_n: int, depth: int,
           lanes: Optional[int] = None) -> Layout:
    """The kernel's shared layout at a plan (``lanes`` None: the rule's,
    ``kmeans_lanes``).  Rows of a multiple of 16 bytes keep their stride
    and stream by 16-byte ``cp.async``; other rows by 4-byte copies."""
    lanes = kmeans_lanes(k, d) if lanes is None else lanes
    if lanes not in LANE_CHOICES:
        raise ValueError(f"lanes must be one of {LANE_CHOICES}, got {lanes}")
    ring = _r4(depth * block_n * d)
    stage = DAG_WARPS * piece_words(lanes)
    words = ring + _r4(k * d) + _r4(k * d + k) + stage
    return Layout(lanes, d % 4 == 0, 4 * ring, 4 * stage, 4 * words)


def source(k: int, d: int, block_n: int, depth: int, lanes: int) -> str:
    """The translation unit of the kernel at one shape and plan: the
    template ``fkm::kmeans_kernel`` with its generated ``Cam`` (the sums
    at ``lanes`` column slots, the counts at one)."""
    cam = cam_struct_c([("sum", k, d, lanes, "v[{}]".format),
                        ("cnt", k, 1, 1, lambda c: "1.0f")], d)
    args = f"{k}, {d}, {block_n}, {depth}, Cam"
    return f'''// one k-means step at k = {k}, d = {d}, block {block_n}, depth {depth}, the sums at
// {lanes} column slot(s); generated by kernels.fused_kmeans from fused_kmeans.cuh
#include "fused_kmeans.cuh"

namespace {{
{cam}

using Layout = fkm::Layout<{k}, {d}, {block_n}, {depth}, Cam::STAGE_WORDS>;
}}  // namespace

extern "C" int per_sm(int variant, int smem, int* n) {{
  return tcopy::blocks_per_sm(fkm::kmeans_kernel<{args}>, smem, n);
}}

extern "C" int layout(int* bytes) {{
  *bytes = Layout::BYTES;
  return 0;
}}

extern "C" int fused_kmeans_launch(const void* points, const void* cents,
                                   long long steps, int ctas, void* partials,
                                   void* stream) {{
  fkm::kmeans_kernel<{args}><<<ctas, tcopy::THREADS, Layout::BYTES,
                               (cudaStream_t)stream>>>(
      (const float*)points, (const float*)cents, steps, (float*)partials);
  return (int)cudaGetLastError();
}}

extern "C" int combine(const void* partials, const void* init, void* out,
                       int ctas, int width, void* stream) {{
  return fdag::launch_combine((const float*)partials, (const float*)init,
                              (float*)out, ctas, width, (cudaStream_t)stream);
}}
'''


_VP, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "per_sm": [_INT, _INT, ctypes.POINTER(_INT)],
    "layout": [ctypes.POINTER(_INT)],
    "fused_kmeans_launch": [_VP, _VP, ctypes.c_longlong, _INT, _VP, _VP],
    "combine": [_VP, _VP, _VP, _INT, _INT, _VP]}
_LIBS: Dict[Tuple[int, ...], build.Library] = {}


def library(k: int, d: int, block_n: int, depth: int,
            lanes: int) -> build.Library:
    """The kernel's library at one shape and plan (built at first use)."""
    key = (k, d, block_n, depth, lanes)
    if key not in _LIBS:
        _LIBS[key] = build.Library("fused_kmeans", source(*key), ARGTYPES)
    return _LIBS[key]


def _auto_plan(n: int, k: int, d: int, device,
               **tuning) -> Tuple[int, int]:
    from .ops import resolve_plan
    bn, plan = resolve_plan("fused_kmeans", n, k, d, device=device,
                            **tuning)
    return bn, plan.depth


def _inputs(points, centroids, device) -> Tuple[torch.Tensor, torch.Tensor]:
    points, centroids = place((points, centroids), device)
    if points.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(f"points and centroids must be float32, got "
                         f"{points.dtype} and {centroids.dtype}")
    if points.dim() != 2 or centroids.dim() != 2 \
            or points.shape[1] != centroids.shape[1]:
        raise ValueError(f"points {tuple(points.shape)} and centroids "
                         f"{tuple(centroids.shape)}: (n, d) and (k, d)")
    return points, centroids


def fused_kmeans_plain(points: torch.Tensor, centroids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_kmeans_step``: every point at
    once; the nearest centroid by the squared distance summed over d in
    index order (``analytics.sq_dist``, first minimum), then sums and
    counts by ``index_add`` in float64, returned as float32."""
    points, centroids = _inputs(points, centroids, None)
    k = centroids.shape[0]
    assign = torch.argmin(sq_dist(centroids[None], points[:, None]), -1)
    sums = torch.zeros(k, points.shape[1], dtype=torch.float64,
                       device=points.device)
    sums.index_add_(0, assign, points.double())
    counts = torch.bincount(assign, minlength=k)
    return sums.float(), counts.float()


def fused_kmeans_step(points, centroids, *, block_n: int = 128,
                      depth: int = 2, lanes: Optional[int] = None,
                      auto_tile: bool = False, device=None,
                      measure: Optional[str] = None, policy=None,
                      options=None, cache=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One k-means update step as a single two-output kernel: returns
    ``(sums, counts)``, ``sums[c]`` the sum of the points nearest
    centroid c and ``counts[c]`` their number, both float32.  points
    (n, d) and centroids (k, d) are float32; ``block_n`` points per grid
    step must divide n; ``depth`` ring slots (at least 2) stream them.
    ``auto_tile=True`` takes the joint DSE's block and depth for the
    assign -> {sum, count} DAG (``dse.select_fused_kmeans_blocks``) for
    the tier of the device the inputs are on.  ``lanes`` sets the sums'
    column slots (None: ``kmeans_lanes``).  On the card the layout
    (``layout``) must fit a block's shared memory and the accumulators
    its registers, else ``ValueError`` before any launch.  Replaces the
    TPU kernel ``fused_kmeans_step`` (reference kernels/fused_kmeans.py).
    """
    points, centroids = _inputs(points, centroids, device)
    (n, d), k = points.shape, centroids.shape[0]
    if auto_tile:
        block_n, depth = _auto_plan(
            n, k, d, points.device, measure=measure, policy=policy,
            options=options, cache=cache)
    block_n = min(block_n, n)
    if n % block_n:
        raise ValueError(f"block_n {block_n} must divide n = {n}")
    if depth < 2:
        raise ValueError(f"ring depth must be >= 2, got {depth}")
    if points.device.type == "cpu":
        return fused_kmeans_plain(points, centroids)
    if not (points.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("fused_kmeans_step takes contiguous inputs")
    lay = layout(k, d, block_n, depth, lanes)
    if lay.vec:   # 16-byte cp.async reads the points
        points = build.aligned(points)
    dev = points.device
    lib = library(k, d, block_n, depth, lay.lanes)
    ctas = lib.persistent_ctas(dev, 0, lay.smem_bytes, n // block_n)
    lib.check_layout(lay.smem_bytes)
    partials = torch.empty((ctas, k * d + k), dtype=torch.float32,
                           device=dev)
    lib("fused_kmeans_launch", points.data_ptr(), centroids.data_ptr(),
        n // block_n, ctas, partials.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    out = lib.combine(partials)
    fused_kmeans_step.launches += 1
    fused_kmeans_step.ctas = ctas
    fused_kmeans_step.lanes = lay.lanes
    return out[:k * d].reshape(k, d), out[k * d:]


fused_kmeans_step.launches = 0
fused_kmeans_step.ctas = 0
fused_kmeans_step.lanes = 0
