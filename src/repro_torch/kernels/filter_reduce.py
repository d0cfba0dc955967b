"""Filter+reduce kernel (TPC-H Q6 shape): predicate, weighted sum.

The FlatMap(filter)+fold fusion of the paper: ``filter_reduce`` folds
each row's ``where(lo <= x < hi, x * w, 0)`` as it reads it, through the
CUDA kernel ``csrc/filter_fold.cuh`` for CUDA tensors and through its
plain PyTorch version, ``filter_reduce_plain``, for CPU tensors.  The
header's staged kernel serves ``fused_filter_fold``; both share the
launch below.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build
from ..device import place

SOURCE = '''// TPC-H Q6 filter-fold: filter_fold.cuh's two kernels
#include "filter_fold.cuh"

extern "C" int per_sm(int staged, int smem, int* n) {
  using ffold::filter_fold_kernel;
  return staged ? tcopy::blocks_per_sm(filter_fold_kernel<true>, smem, n)
                : tcopy::blocks_per_sm(filter_fold_kernel<false>, smem, n);
}

extern "C" int filter_fold_launch(const void* x, const void* w, float lo,
                                  float hi, int block_t, long long steps,
                                  int staged, int ctas, int smem,
                                  void* partials, void* stream) {
  const float* xs = (const float*)x;
  const float* ws = (const float*)w;
  float* part = (float*)partials;
  cudaStream_t s = (cudaStream_t)stream;
  if (staged)
    ffold::filter_fold_kernel<true><<<ctas, tcopy::THREADS, smem, s>>>(
        xs, ws, lo, hi, block_t, steps, part);
  else
    ffold::filter_fold_kernel<false><<<ctas, tcopy::THREADS, smem, s>>>(
        xs, ws, lo, hi, block_t, steps, part);
  return (int)cudaGetLastError();
}

extern "C" int combine(const void* partials, const void* init, void* out,
                       int ctas, int width, void* stream) {
  return fdag::launch_combine((const float*)partials, (const float*)init,
                              (float*)out, ctas, width, (cudaStream_t)stream);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("filter_fold", SOURCE, {
    "per_sm": [_INT, _INT, ctypes.POINTER(_INT)],
    "filter_fold_launch": [_VP, _VP, ctypes.c_float, ctypes.c_float, _INT,
                           ctypes.c_longlong, _INT, _INT, _INT, _VP, _VP],
    "combine": [_VP, _VP, _VP, _INT, _INT, _VP]})

SCRATCH_WORDS = 32   # reduction scratch of fdag::block_sum


def _auto_blocks(t: int, device) -> int:
    from .ops import resolve_plan
    bt, _ = resolve_plan("filter_reduce", t, device=device)
    return bt


def inputs(x, weight, lo, hi, block_t: int, device):
    """The checked inputs of a filter-fold: ``x`` and ``weight`` (any
    floating types) as (t,) float32 tensors on one device, the bounds
    rounded to float32 (as the reference rounds them), and ``block_t``
    clipped to t; raises unless block_t divides t."""
    x, weight = place((x, weight), device)
    if x.dim() != 1 or weight.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)}: two (t,) vectors")
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise ValueError(f"x and weight must be floating point, got "
                         f"{x.dtype} and {weight.dtype}")
    # read as float32, as the reference's kernel reads them
    x, weight = x.float(), weight.float()
    lo, hi = float(np.float32(lo)), float(np.float32(hi))
    block_t = min(block_t, x.shape[0])
    if x.shape[0] % block_t:
        raise ValueError(f"block_t {block_t} must divide t = {x.shape[0]}")
    return x, weight, lo, hi, block_t


def filter_fold_plain(x: torch.Tensor, weight: torch.Tensor, lo: float,
                      hi: float) -> torch.Tensor:
    """Plain PyTorch version of both filter-fold kernels: the float32
    contributions ``where(lo <= x < hi, x * w, 0)`` of the whole input
    (bounds already float32 values), summed in float64 and returned as a
    float32 scalar."""
    contrib = torch.where((x >= lo) & (x < hi), x * weight, 0.0)
    return contrib.double().sum().float()


def launch(x: torch.Tensor, weight: torch.Tensor, lo: float, hi: float,
           block_t: int, staged: bool) -> Tuple[torch.Tensor, int]:
    """Launch the filter-fold kernel (``staged`` keeps the filter stage's
    output in shared memory) and the ordered combine of its per-block
    partials; returns ``(sum, blocks)``.  Raises before any launch when a
    staged step does not fit a block's shared memory."""
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("the filter-fold kernels take contiguous inputs")
    dev = x.device
    steps = x.shape[0] // block_t
    smem = 4 * (max(block_t, SCRATCH_WORDS) if staged else SCRATCH_WORDS)
    ctas = LIB.persistent_ctas(dev, int(staged), smem, steps)
    partials = torch.empty((ctas, 1), dtype=torch.float32, device=dev)
    LIB("filter_fold_launch", x.data_ptr(), weight.data_ptr(), lo, hi,
        block_t, steps, int(staged), ctas, smem,
        partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return LIB.combine(partials)[0], ctas


def filter_reduce_plain(x: torch.Tensor, weight: torch.Tensor, lo,
                        hi) -> torch.Tensor:
    """Plain PyTorch version of ``filter_reduce``."""
    x, weight, lo, hi, _ = inputs(x, weight, lo, hi, x.shape[0], None)
    return filter_fold_plain(x, weight, lo, hi)


def filter_reduce(x, weight, lo, hi, *, block_t: int = 1024,
                  auto_tile: bool = False, device=None) -> torch.Tensor:
    """``sum(where(lo <= x < hi, x * weight, 0))`` as a float32 scalar,
    the bounds rounded to float32 first.  x and weight are (t,) floating
    point, read as float32; ``block_t`` rows per grid step must divide t.
    ``auto_tile=True`` takes the DSE's block for the fused filter+fold proxy
    (``dse.select_filter_reduce_blocks``) for the tier of the device the
    inputs are on.  Replaces the TPU kernel ``filter_reduce`` (reference
    kernels/filter_reduce.py)."""
    if auto_tile:
        x, weight = place((x, weight), device)
        block_t = _auto_blocks(x.shape[0], x.device)
    x, weight, lo, hi, block_t = inputs(x, weight, lo, hi, block_t, device)
    if x.device.type == "cpu":
        return filter_fold_plain(x, weight, lo, hi)
    out, filter_reduce.ctas = launch(x, weight, lo, hi, block_t, False)
    filter_reduce.launches += 1
    return out


filter_reduce.launches = 0
filter_reduce.ctas = 0
