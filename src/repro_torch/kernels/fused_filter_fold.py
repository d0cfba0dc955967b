"""Fused filter->fold megakernel (TPC-H Q6 pipeline, paper Fig. 5b/6).

The two-stage pipeline as ONE kernel: the filter stage writes each
step's per-record contributions into shared memory (the pipeline
intermediate, which never reaches main memory) and the fold stage sums
that buffer.  Compare ``filter_reduce``, which folds the predicate into
the reduction: this kernel keeps the two stages distinct, the shape
``core.pipeline`` generates for pattern chains.  It is the staged kernel
of ``csrc/filter_fold.cuh`` for CUDA tensors and the plain PyTorch
version ``fused_filter_fold_plain`` for CPU tensors: one cooperative
launch a call, the rows through a ``cp.async`` ring at the plan's
depth, the stage's output at as many slots (the bytes the pipeline plan
charges), the blocks' partials added in block order inside the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import place
from .filter_reduce import filter_fold_plain, inputs, launch


def _auto_blocks(t: int, device, **tuning) -> Tuple[int, int]:
    from .ops import resolve_plan
    bt, plan = resolve_plan("fused_filter_fold", t, device=device,
                            **tuning)
    return bt, plan.depth


def fused_filter_fold_plain(x: torch.Tensor, weight: torch.Tensor, lo,
                            hi) -> torch.Tensor:
    """Plain PyTorch version of ``fused_filter_fold``."""
    x, weight, lo, hi, _ = inputs(x, weight, lo, hi, x.shape[0], None)
    return filter_fold_plain(x, weight, lo, hi)


def fused_filter_fold(x, weight, lo, hi, *, block_t: int = 1024,
                      auto_tile: bool = False, device=None,
                      measure: Optional[str] = None, policy=None,
                      options=None, cache=None) -> torch.Tensor:
    """``sum(where(lo <= x < hi, x * weight, 0))`` as a fused two-stage
    kernel, the bounds rounded to float32 first.  x and weight are (t,)
    floating point, read as float32; ``block_t`` rows per grid step must
    divide t, and on the card ``block_t`` floats must fit a block's
    shared memory (else ``ValueError`` before any launch).
    ``auto_tile=True`` takes the joint DSE's block and depth for the
    filter -> fold pipeline (``dse.select_fused_filter_fold_blocks``) for
    the tier of the device the inputs are on; otherwise the ring has 2
    slots.  Replaces the TPU kernel ``fused_filter_fold`` (reference
    kernels/fused_filter_fold.py)."""
    depth = 2
    if auto_tile:
        x, weight = place((x, weight), device)
        block_t, depth = _auto_blocks(
            x.shape[0], x.device, measure=measure, policy=policy,
            options=options, cache=cache)
    x, weight, lo, hi, block_t = inputs(x, weight, lo, hi, block_t, device)
    if x.device.type == "cpu":
        return filter_fold_plain(x, weight, lo, hi)
    out, fused_filter_fold.ctas, fused_filter_fold.form = launch(
        x, weight, lo, hi, block_t, True, depth)
    fused_filter_fold.launches += 1
    return out


fused_filter_fold.launches = 0
fused_filter_fold.ctas = 0
fused_filter_fold.form = None
