"""Public wrappers of the hand-written kernels.

Every op takes ``use_kernel``: True -> the CUDA kernel (its plain
PyTorch version for CPU tensors); False -> the ``ref`` oracle.  Both
paths are held against each other in the tests.

``resolve_plan`` is the shared auto-tile front door: every kernel's
``auto_tile=True`` path resolves its DSE plan here (one memo, one
selector table) instead of carrying a private selector call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import filter_reduce as _fr
from . import flash_attention as _fa
from . import groupby_fold as _gbf
from . import matmul as _mm
from . import ref
from . import ssd_scan as _ssd
from ..device import place

# pattern-domain kind -> core.dse selector; every selector returns
# (blocks, plan) where ``blocks`` is whatever tile tuple or scalar the
# kernel consumes
_SELECTORS = {
    "gemm": "select_gemm_blocks",
    "attention": "select_attention_blocks",
    "scan": "select_scan_blocks",
    "filter_reduce": "select_filter_reduce_blocks",
    "groupby": "select_groupby_blocks",
    "fused_filter_fold": "select_fused_filter_fold_blocks",
    "fused_kmeans": "select_fused_kmeans_blocks",
    "paged_decode": "select_paged_decode_blocks",
}

_PLAN_MEMO: dict = {}


def resolve_plan(kind: str, *shape: int, tier=None, device=None,
                 measure: Optional[str] = None, policy=None, options=None,
                 cache=None):
    """Resolve the DSE tile plan for ``kind`` at ``shape``.

    Returns the selector's ``(blocks, plan)``: ``blocks`` is the tile
    tuple (or scalar) the kernel consumes, ``plan`` the full
    ``TilePlan`` / ``PipelinePlan``.  The plan is for ``tier``, else for
    the tier of ``device`` (the card unless the caller names another
    device).  ``measure="top_k"`` backs it with timings on ``device``;
    ``policy``, ``options`` and ``cache`` pass through to the DSE.
    Results are memoised in-process per (kind, shape, tier or device,
    tuning arguments) -- counted as ``ops.memo_hits`` -- so a kernel's
    ``auto_tile=True`` call does no planning after its first.
    """
    from ..core import dse, telemetry

    if kind not in _SELECTORS:
        raise ValueError(f"unknown plan kind {kind!r}; "
                         f"one of {sorted(_SELECTORS)}")
    key = (kind, shape, tier, None if tier is not None else str(device),
           measure, policy, options, cache)
    try:
        hit = _PLAN_MEMO.get(key)
    except TypeError:      # unhashable policy/options/cache: no memo
        key = hit = None
    if hit is not None:
        telemetry.count("ops.memo_hits")
        return hit
    with telemetry.span("ops.resolve_plan", kind=kind, shape=list(shape)):
        result = getattr(dse, _SELECTORS[kind])(
            *shape, tier=dse.tier_of(tier, device), device=device,
            measure=measure, policy=policy, options=options, cache=cache)
    if key is not None:
        _PLAN_MEMO[key] = result
    return result


def clear_plan_memo() -> None:
    """Drop the in-process plan memo."""
    _PLAN_MEMO.clear()


def matmul(x, y, *, use_kernel: bool = True, block_m: int = 128,
           block_n: int = 128, block_k: int = 128, device=None):
    if use_kernel:
        return _mm.matmul(x, y, block_m=block_m, block_n=block_n,
                          block_k=block_k, device=device)
    x, y = place((x, y), device)
    return ref.matmul(x, y).to(x.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              use_kernel: bool = True, block_q: int = 128,
              block_k: int = 128, device=None):
    if use_kernel:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k,
                                   device=device)
    q, k, v = place((q, k, v), device)
    return ref.attention(q, k, v, causal=causal, window=window)


def ssd(x, dt, A, B, C, *, chunk: int = 128, use_kernel: bool = True,
        device=None):
    if use_kernel:
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, device=device)
    x, dt, A, B, C = place((x, dt, A, B, C), device)
    return ref.ssd_scan(x, dt, A, B, C)


def groupby(keys, values, num_keys: int, *, use_kernel: bool = True,
            block_t: int = 256, device=None):
    if use_kernel:
        return _gbf.groupby_fold(keys, values, num_keys, block_t=block_t,
                                 device=device)
    keys, values = place((keys, values), device)
    return ref.groupby_fold(keys, values, num_keys)


def filter_sum(x, weight, lo, hi, *, use_kernel: bool = True,
               block_t: int = 1024, device=None):
    if use_kernel:
        return _fr.filter_reduce(x, weight, lo, hi, block_t=block_t,
                                 device=device)
    x, weight = place((x, weight), device)
    return ref.filter_reduce(x, float(np.float32(lo)), float(np.float32(hi)),
                             weight)
