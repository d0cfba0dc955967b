"""Tiled GEMM -- the paper's Table 3 worked example, hand-written.

``matmul`` computes ``x @ y`` with a float32 accumulator, cast to
``out_dtype``, through the CUDA kernel ``csrc/matmul.cuh`` for CUDA
tensors and through its plain PyTorch version, ``matmul_plain``, for CPU
tensors.  Each block of the kernel owns one ``(block_m, block_n)``
output tile and loops over K itself; ``block_k`` is the grain K is
staged in.  Block sizes default to 128; ``auto_tile=True`` takes the
DSE's plan for this (m, n, k) instead (``ops.resolve_plan("gemm")``),
for the tier of the device the inputs are on.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from ..device import place

KC_MAX = 32          # hmm::KC_MAX: K words the kernel stages per step
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// hand-tiled matmul: matmul.cuh's kernel per input and output type
#include "matmul.cuh"

extern "C" int matmul_launch(const void* x, const void* y, void* out, int m,
                             int n, int k, int bm, int bn, int kc,
                             int in_bf16, int out_bf16, void* stream) {
  using bf16 = __nv_bfloat16;
  using Launch = int (*)(const void*, const void*, void*, int, int, int, int,
                         int, int, cudaStream_t);
  const Launch run = in_bf16 ? (out_bf16 ? &hmm::launch<bf16, bf16>
                                         : &hmm::launch<bf16, float>)
                             : (out_bf16 ? &hmm::launch<float, bf16>
                                         : &hmm::launch<float, float>);
  return run(x, y, out, m, n, k, bm, bn, kc, (cudaStream_t)stream);
}
'''

LIB = build.Library("matmul", SOURCE, {
    "matmul_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p]})


def _auto_blocks(m: int, n: int, k: int, device) -> Tuple[int, int, int]:
    from .ops import resolve_plan
    blocks, _ = resolve_plan("gemm", m, n, k, device=device)
    return blocks


def k_chunk(block_k: int) -> int:
    """K words the kernel stages per step: the largest divisor of
    ``block_k`` up to ``KC_MAX``."""
    return max(c for c in range(1, min(block_k, KC_MAX) + 1)
               if block_k % c == 0)


def matmul_plain(x: torch.Tensor, y: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``matmul``: the product in float32,
    rounded once to ``out_dtype``."""
    return (x.float() @ y.float()).to(out_dtype)


def matmul(x, y, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128, out_dtype: Optional[torch.dtype] = None,
           auto_tile: bool = False, device=None) -> torch.Tensor:
    """``x @ y`` with explicit tiling; the blocks must divide the shape.

    x (m, k) and y (k, n) of any floating type: two bfloat16 inputs run
    as they are, any other pair in float32, as the reference's kernel
    accumulates whatever it is given in float32.  The result is
    ``out_dtype`` (default ``x.dtype``), rounded once.  Runs on
    ``device`` (default: where the tensors are, CUDA for arrays).
    ``auto_tile=True`` replaces the blocks with the DSE plan.  Replaces
    the TPU kernel ``matmul`` (reference kernels/matmul.py).
    """
    x, y = place((x, y), device)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul of {tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_floating_point() and y.is_floating_point()):
        raise ValueError(f"matmul takes floating-point inputs, got "
                         f"{x.dtype} and {y.dtype}")
    out_dtype = out_dtype or x.dtype
    # the reference's kernel multiplies whatever it is given with a
    # float32 accumulator; here bfloat16 pairs run as they are and every
    # other pair runs in float32
    if not x.dtype == y.dtype == torch.bfloat16:
        x, y = x.float(), y.float()
    kernel_out = out_dtype if out_dtype in _DTYPES else torch.float32
    (m, k), n = x.shape, y.shape[1]
    if auto_tile:
        block_m, block_n, block_k = _auto_blocks(m, n, k, x.device)
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), \
        min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"blocks ({block_m}, {block_n}, {block_k}) must "
                         f"divide ({m}, {n}, {k})")
    if x.device.type == "cpu":
        return matmul_plain(x, y, out_dtype)
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul takes contiguous inputs")
    if m // block_m > 65535:
        raise ValueError(f"{m // block_m} row blocks: at most 65535")
    out = torch.empty(m, n, dtype=kernel_out, device=x.device)
    LIB("matmul_launch", x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
        block_m, block_n, k_chunk(block_k), _DTYPES[x.dtype],
        _DTYPES[kernel_out], torch.cuda.current_stream(x.device).cuda_stream)
    matmul.launches += 1
    return out.to(out_dtype)


matmul.launches = 0
