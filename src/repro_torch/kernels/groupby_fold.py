"""GroupByFold kernel: dense keyed reduction (the paper's CAM template).

``groupby_fold`` sums each row's values into the row of its key, keys
outside ``[0, num_keys)`` dropped, through the CUDA kernel
``csrc/groupby_fold.cuh`` for CUDA tensors and through its plain PyTorch
version, ``groupby_fold_plain``, for CPU tensors.  The kernel takes no
atomics and sums in one fixed order; ``table_form`` picks its form per
table (register accumulators for small tables such as MoE's expert
counts, per-(warp, row group) shared tables for the rest), and one
library is built per ``(num_keys, E, block_t, form)`` (``source``).
Used by MoE routing (expert counts) and the histogram benchmarks.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build
from ..core.codegen_cuda import CAM_REG_WORDS, DAG_WARPS, cam_struct_c
from ..device import place

# lane instructions the H100 issues per byte it reads from its memory:
# 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz over 3.35 TB/s
ISSUE_PER_BYTE = 10


def shared_bytes(num_keys: int, ew: int, groups: int) -> int:
    """A block's shared bytes in the shared form (``gbf::Shared``): one
    table per (warp, row group), ``groups`` row groups a warp, each table
    ``num_keys * ew`` words rounded up to 32 plus 32 / groups words when a
    warp has several, so the groups' rows of one key start in different
    banks."""
    lanes = 32 // groups
    stride = -(-num_keys * ew // 32) * 32 + (lanes if groups > 1 else 0)
    return 4 * DAG_WARPS * groups * stride


def table_form(num_keys: int, ew: int, smem_limit: int) -> Tuple[str, int]:
    """The kernel's form for a ``(num_keys, ew)`` table on a card whose
    blocks may use ``smem_limit`` bytes of shared memory:

    * ``("register", 1)``: fused_dag.cuh's CAM at P = 1, each lane adding
      its own row into ``num_keys * ew`` register accumulators, when they
      fit CAM_REG_WORDS and a row's ``num_keys`` compares and
      ``num_keys * ew`` predicated adds stay within ISSUE_PER_BYTE lane
      instructions per byte of the row (4 + 4 ew): up to 40 keys;
    * ``("shared", R)``: per-(warp, row group) tables in shared memory,
      one read-modify-write per value, R row groups of 32 / R lanes a warp
      (32 / R the least power of two of at least ``ew`` lanes, at most
      32), R halved until the tables fit ``smem_limit``;
    * else ``ValueError`` naming shared memory.
    """
    if num_keys * ew <= CAM_REG_WORDS \
            and num_keys * (ew + 1) <= ISSUE_PER_BYTE * 4 * (1 + ew):
        return "register", 1
    lanes = 1
    while lanes < min(ew, 32):
        lanes *= 2
    groups = 32 // lanes
    while groups >= 1:
        if shared_bytes(num_keys, ew, groups) <= smem_limit:
            return "shared", groups
        groups //= 2
    raise ValueError(
        f"groupby_fold: a ({num_keys}, {ew}) table takes no form: the "
        f"register form holds {CAM_REG_WORDS} words a lane, the shared "
        f"form needs {shared_bytes(num_keys, ew, 1)} B of shared memory "
        f"per block; the card allows {smem_limit} B")


def source(num_keys: int, ew: int, block_t: int, form: str,
           groups: int) -> str:
    """The translation unit of the kernel at one table, block and form:
    ``gbf::register_kernel`` with its generated ``Cam``, or
    ``gbf::shared_kernel`` at ``groups`` row groups a warp."""
    if form == "register":
        cam = cam_struct_c([("acc", num_keys, ew, 1, "v[{}]".format)], ew)
        kernel = f"gbf::register_kernel<{num_keys}, {ew}, {block_t}, Cam>"
        smem = f"4 * {num_keys} * {ew}"
    else:
        cam = ""
        kernel = f"gbf::shared_kernel<{num_keys}, {ew}, {block_t}, {groups}>"
        smem = f"gbf::Shared<{num_keys}, {ew}, {groups}>::BYTES"
    return f'''// dense keyed sum of a ({num_keys}, {ew}) table at block {block_t}, {form} form
// ({groups} row group(s) a warp); generated by kernels.groupby_fold from groupby_fold.cuh
#include "groupby_fold.cuh"

namespace {{
{cam}
}}  // namespace

extern "C" int per_sm(int variant, int smem, int* n) {{
  return tcopy::blocks_per_sm({kernel}, smem, n);
}}

extern "C" int layout(int* bytes) {{
  *bytes = {smem};
  return 0;
}}

extern "C" int groupby_fold_launch(const void* keys, const void* values,
                                   long long steps, int ctas, void* partials,
                                   void* stream) {{
  {kernel}<<<ctas, tcopy::THREADS, {smem}, (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)values, steps, (float*)partials);
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
    "groupby_fold_launch": [_VP, _VP, ctypes.c_longlong, _INT, _VP, _VP],
    "combine": [_VP, _VP, _VP, _INT, _INT, _VP]}
_LIBS: Dict[Tuple, build.Library] = {}


def library(num_keys: int, ew: int, block_t: int, form: str,
            groups: int) -> build.Library:
    """The kernel's library at one table, block and form (built at first
    use)."""
    key = (num_keys, ew, block_t, form, groups)
    if key not in _LIBS:
        _LIBS[key] = build.Library("groupby_fold", source(*key), ARGTYPES)
    return _LIBS[key]


def _auto_blocks(t: int, num_keys: int, ew: int, device, **tuning) -> int:
    from .ops import resolve_plan
    bt, _ = resolve_plan("groupby", t, num_keys, ew, device=device,
                         **tuning)
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
                 auto_tile: bool = False, device=None,
                 measure: Optional[str] = None, policy=None, options=None,
                 cache=None) -> torch.Tensor:
    """out[k] = sum over i with keys[i] == k of values[i].

    keys (t,) integers, cast to int32; values (t,) or (t, E) floating
    point, summed in float32 -> out (num_keys,) or (num_keys, E) float32.
    Keys outside ``[0, num_keys)`` are dropped.
    ``block_t`` rows per grid step must divide t; on the card the table
    must take a form (``table_form``: else ``ValueError`` before any
    launch).  ``auto_tile=True`` takes the DSE's block for the keyed-fold
    proxy (``dse.select_groupby_blocks``) for the tier of the device the
    inputs are on.  Counts launches per form (``.register_launches``,
    ``.shared_launches``) and keeps the last one's ``.form``.  Replaces
    the TPU kernel ``groupby_fold`` (reference kernels/groupby_fold.py)."""
    keys, values = _inputs(keys, values, device)
    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    t, ew = vals.shape
    if auto_tile:
        block_t = _auto_blocks(t, num_keys, ew, keys.device,
                               measure=measure, policy=policy,
                               options=options, cache=cache)
    block_t = min(block_t, t)
    if t % block_t:
        raise ValueError(f"block_t {block_t} must divide t = {t}")
    if keys.device.type == "cpu":
        return groupby_fold_plain(keys, values, num_keys)
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("groupby_fold takes contiguous inputs")
    dev = keys.device
    form, groups = table_form(num_keys, ew, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    smem = shared_bytes(num_keys, ew, groups) if form == "shared" \
        else 4 * num_keys * ew
    lib = library(num_keys, ew, block_t, form, groups)
    ctas = lib.persistent_ctas(dev, 0, smem, t // block_t)
    lib.check_layout(smem)
    width = num_keys * ew
    partials = torch.empty((ctas, width), dtype=torch.float32, device=dev)
    lib("groupby_fold_launch", keys.data_ptr(), vals.data_ptr(),
        t // block_t, ctas, partials.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    out = lib.combine(partials)
    groupby_fold.launches += 1
    if form == "register":
        groupby_fold.register_launches += 1
    else:
        groupby_fold.shared_launches += 1
    groupby_fold.form = form
    groupby_fold.ctas = ctas
    return out if squeeze else out.reshape(num_keys, ew)


groupby_fold.launches = 0
groupby_fold.register_launches = 0
groupby_fold.shared_launches = 0
groupby_fold.form = ""
groupby_fold.ctas = 0
