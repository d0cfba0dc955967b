"""Fused k-means step megakernel (the paper's Fig. 4/5 DAG, one kernel).

The assign -> {scatter-sum, count} DAG as ONE kernel with two outputs:
the assign stage writes each point's nearest centroid into a shared
buffer (the fan-out intermediate, computed once per tile), and both
terminals read it: the per-centroid coordinate sums and the counts.
The centroids are copied into shared memory once per block (the Pipe-0
preload).  It is ``csrc/fused_kmeans.cuh`` for CUDA tensors and the
plain PyTorch version ``fused_kmeans_plain`` for CPU tensors; the
compiler generates the same function from
``patterns.analytics.kmeans_pipeline`` (``codegen_cuda.fused_dag``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from ..device import place
from ..patterns.analytics import sq_dist

SOURCE = '''// one k-means step: fused_kmeans.cuh's kernel
#include "fused_kmeans.cuh"

extern "C" int per_sm(int variant, int smem, int* n) {
  return tcopy::blocks_per_sm(fkm::fused_kmeans_kernel, smem, n);
}

extern "C" int fused_kmeans_launch(const void* points, const void* cents,
                                   int k, int d, int block_n,
                                   long long steps, int ctas, int smem,
                                   void* partials, void* stream) {
  fkm::fused_kmeans_kernel<<<ctas, tcopy::THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const float*)points, (const float*)cents, k, d, block_n, steps,
      (float*)partials);
  return (int)cudaGetLastError();
}

extern "C" int combine(const void* partials, const void* init, void* out,
                       int ctas, int width, void* stream) {
  return fdag::launch_combine((const float*)partials, (const float*)init,
                              (float*)out, ctas, width, (cudaStream_t)stream);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("fused_kmeans", SOURCE, {
    "per_sm": [_INT, _INT, ctypes.POINTER(_INT)],
    "fused_kmeans_launch": [_VP, _VP, _INT, _INT, _INT, ctypes.c_longlong,
                            _INT, _INT, _VP, _VP],
    "combine": [_VP, _VP, _VP, _INT, _INT, _VP]})


def smem_bytes(k: int, d: int, block_n: int) -> int:
    """Shared bytes a block of the kernel uses (the layout at the top of
    ``fkm::fused_kmeans_kernel``): the centroids, the (k, d) sums and
    (k,) counts, the points tile with its rows padded to an odd stride,
    and the block_n assignment."""
    return 4 * (2 * k * d + k + block_n * ((d | 1) + 1))


def _auto_blocks(n: int, k: int, d: int, device) -> int:
    from .ops import resolve_plan
    bn, _ = resolve_plan("fused_kmeans", n, k, d, device=device)
    return bn


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
                      auto_tile: bool = False, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One k-means update step as a single two-output kernel: returns
    ``(sums, counts)``, ``sums[c]`` the sum of the points nearest
    centroid c and ``counts[c]`` their number, both float32.  points
    (n, d) and centroids (k, d) are float32; ``block_n`` points per grid
    step must divide n, and on the card a block's shared memory
    (``smem_bytes``) must fit (else ``ValueError`` before any launch).
    ``auto_tile=True`` takes the joint DSE's block for the assign ->
    {sum, count} DAG (``dse.select_fused_kmeans_blocks``) for the tier of
    the device the inputs are on.  Replaces the TPU kernel
    ``fused_kmeans_step`` (reference kernels/fused_kmeans.py)."""
    points, centroids = _inputs(points, centroids, device)
    (n, d), k = points.shape, centroids.shape[0]
    if auto_tile:
        block_n = _auto_blocks(n, k, d, points.device)
    block_n = min(block_n, n)
    if n % block_n:
        raise ValueError(f"block_n {block_n} must divide n = {n}")
    if points.device.type == "cpu":
        return fused_kmeans_plain(points, centroids)
    if not (points.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("fused_kmeans_step takes contiguous inputs")
    dev = points.device
    smem = smem_bytes(k, d, block_n)
    ctas = LIB.persistent_ctas(dev, 0, smem, n // block_n)
    partials = torch.empty((ctas, k * d + k), dtype=torch.float32,
                           device=dev)
    LIB("fused_kmeans_launch", points.data_ptr(), centroids.data_ptr(), k, d,
        block_n, n // block_n, ctas, smem, partials.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    out = LIB.combine(partials)
    fused_kmeans_step.launches += 1
    fused_kmeans_step.ctas = ctas
    return out[:k * d].reshape(k, d), out[k * d:]


fused_kmeans_step.launches = 0
fused_kmeans_step.ctas = 0
