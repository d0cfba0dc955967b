"""GroupByFold kernel: dense keyed reduction (the paper's CAM template).

``groupby_fold`` sums each row's values into the row of its key, keys
outside ``[0, num_keys)`` dropped, through the CUDA kernel
``csrc/groupby_fold.cuh`` (per-block tables in shared memory, partials
summed in block order) for CUDA tensors and through its plain PyTorch
version, ``groupby_fold_plain``, for CPU tensors.  Used by MoE routing
(expert counts) and the histogram benchmarks.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from ..device import place

SOURCE = '''// dense keyed sum: groupby_fold.cuh's kernel
#include "groupby_fold.cuh"

extern "C" int per_sm(int variant, int smem, int* n) {
  return tcopy::blocks_per_sm(gbf::groupby_fold_kernel, smem, n);
}

extern "C" int groupby_fold_launch(const void* keys, const void* values,
                                   int num_keys, int ew, int block_t,
                                   long long steps, int ctas, int smem,
                                   void* partials, void* stream) {
  gbf::groupby_fold_kernel<<<ctas, tcopy::THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)values, num_keys, ew, block_t, steps,
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
LIB = build.Library("groupby_fold", SOURCE, {
    "per_sm": [_INT, _INT, ctypes.POINTER(_INT)],
    "groupby_fold_launch": [_VP, _VP, _INT, _INT, _INT, ctypes.c_longlong,
                            _INT, _INT, _VP, _VP],
    "combine": [_VP, _VP, _VP, _INT, _INT, _VP]})


def _auto_blocks(t: int, num_keys: int, ew: int, device) -> int:
    from .ops import resolve_plan
    bt, _ = resolve_plan("groupby", t, num_keys, ew, device=device)
    return bt


def _inputs(keys, values, device) -> Tuple[torch.Tensor, torch.Tensor]:
    keys, values = place((keys, values), device)
    if keys.is_floating_point() or keys.is_complex() \
            or not values.is_floating_point():
        raise ValueError(f"keys must be integers and values floating point, "
                         f"got {keys.dtype} and {values.dtype}")
    # as the reference's kernel sums float32 values, and as MoE routing
    # hands it int32 expert ids (int64 keys are cast, as moe.router_counts
    # casts them)
    keys, values = keys.to(torch.int32), values.float()
    if keys.dim() != 1 or values.dim() not in (1, 2) \
            or values.shape[0] != keys.shape[0]:
        raise ValueError(f"keys {tuple(keys.shape)} and values "
                         f"{tuple(values.shape)}: (t,) and (t,) or (t, E)")
    return keys, values


def groupby_fold_plain(keys: torch.Tensor, values: torch.Tensor,
                       num_keys: int) -> torch.Tensor:
    """Plain PyTorch version of ``groupby_fold``: every row at once,
    ``index_add`` in float64 with keys outside ``[0, num_keys)`` dropped,
    returned as float32."""
    keys, values = _inputs(keys, values, None)
    keep = (keys >= 0) & (keys < num_keys)
    out = torch.zeros((num_keys,) + tuple(values.shape[1:]),
                      dtype=torch.float64, device=values.device)
    out.index_add_(0, keys[keep].long(), values[keep].double())
    return out.float()


def groupby_fold(keys, values, num_keys: int, *, block_t: int = 256,
                 auto_tile: bool = False, device=None) -> torch.Tensor:
    """out[k] = sum over i with keys[i] == k of values[i].

    keys (t,) integers, cast to int32; values (t,) or (t, E) floating
    point, summed in float32 -> out (num_keys,) or (num_keys, E) float32.
    Keys outside ``[0, num_keys)`` are dropped.
    ``block_t`` rows per grid step must divide t; on the card a block's
    (num_keys, E) table must fit its shared memory (else ``ValueError``
    before any launch).  ``auto_tile=True`` takes the DSE's block for
    the keyed-fold proxy (``dse.select_groupby_blocks``) for the tier of
    the device the inputs are on.  Replaces the TPU kernel
    ``groupby_fold`` (reference kernels/groupby_fold.py)."""
    keys, values = _inputs(keys, values, device)
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    t, ew = vals.shape
    if auto_tile:
        block_t = _auto_blocks(t, num_keys, ew, keys.device)
    block_t = min(block_t, t)
    if t % block_t:
        raise ValueError(f"block_t {block_t} must divide t = {t}")
    if keys.device.type == "cpu":
        return groupby_fold_plain(keys, values, num_keys)
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("groupby_fold takes contiguous inputs")
    dev = keys.device
    width = num_keys * ew
    ctas = LIB.persistent_ctas(dev, 0, 4 * width, t // block_t)
    partials = torch.empty((ctas, width), dtype=torch.float32, device=dev)
    LIB("groupby_fold_launch", keys.data_ptr(), vals.data_ptr(), num_keys,
        ew, block_t, t // block_t, ctas, 4 * width, partials.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    out = LIB.combine(partials)
    groupby_fold.launches += 1
    groupby_fold.ctas = ctas
    return out if squeeze else out.reshape(num_keys, ew)


groupby_fold.launches = 0
groupby_fold.ctas = 0
