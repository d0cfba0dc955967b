"""Tiled GEMM -- the paper's Table 3 worked example, hand-written.

``matmul`` computes ``x @ y`` with a float32 accumulator, cast to
``out_dtype``, through a CUDA kernel of ``csrc/matmul.cuh`` for CUDA
tensors and through its plain PyTorch version, ``matmul_plain``, for CPU
tensors.  Two kernels, chosen by ``variant``:

* ``wgmma``: two bfloat16 inputs with ``k % 8 == 0`` and ``n % 8 == 0``
  (TMA's 16-byte stride rule) run on the tensor cores, 128 x 256 tiles
  fed by TMA;
* ``ffma``: every other input, widened to float32, runs on FFMA (no TF32:
  the float32 tolerance rules it out), 128 x 128 tiles staged by
  ``cp.async``.

A view off a 16-byte boundary is copied first.  The kernels' tiles are
their own: ``(block_m, block_n, block_k)`` keep the reference's meaning
(they must divide the shape, and the wrapper raises where the reference
asserts) but do not change the grid.  Block sizes default to 128;
``auto_tile=True`` takes the DSE's plan for this (m, n, k) instead
(``ops.resolve_plan("gemm")``), for the tier of the inputs' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from ..device import place

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// hand-tiled matmul: matmul.cuh's kernels per variant and output type
#include "matmul.cuh"

extern "C" int matmul_wgmma(const void* x, const void* y, void* out, int m,
                            int n, int k, int out_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? hmm::launch_wgmma<__nv_bfloat16>(x, y, out, m, n, k, s)
                  : hmm::launch_wgmma<float>(x, y, out, m, n, k, s);
}

extern "C" int matmul_ffma(const void* x, const void* y, void* out, int m,
                           int n, int k, int vec4, int out_bf16,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return out_bf16
             ? hmm::launch_ffma<__nv_bfloat16>(x, y, out, m, n, k, vec4, s)
             : hmm::launch_ffma<float>(x, y, out, m, n, k, vec4, s);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("matmul", SOURCE, {
    "matmul_wgmma": [_VP] * 3 + [_INT] * 4 + [_VP],
    "matmul_ffma": [_VP] * 3 + [_INT] * 5 + [_VP]})


def _auto_blocks(m: int, n: int, k: int, device) -> Tuple[int, int, int]:
    from .ops import resolve_plan
    blocks, _ = resolve_plan("gemm", m, n, k, device=device)
    return blocks


def variant(x_dtype: torch.dtype, y_dtype: torch.dtype, k: int,
            n: int) -> str:
    """The kernel a product of (m, k) x (k, n) inputs of these types
    runs: ``"wgmma"`` for two bfloat16 inputs whose rows are whole 16-byte
    pieces (``k % 8 == 0 and n % 8 == 0``), else ``"ffma"``."""
    if x_dtype == y_dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "ffma"


def ffma_vec(k: int, n: int) -> int:
    """Words per ``cp.async`` of the ffma kernel: 4 (16 bytes) when the
    float32 rows of x and y are whole 16-byte pieces, else 1."""
    return 4 if k % 4 == 0 and n % 4 == 0 else 1


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
    ``device`` (default: where the tensors are, CUDA for arrays), by the
    kernel ``variant`` names; the blocks are checked, not used, by the
    kernels (their own tiles mask ragged edges).
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
    (m, k), n = x.shape, y.shape[1]
    if auto_tile:
        block_m, block_n, block_k = _auto_blocks(m, n, k, x.device)
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), \
        min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"blocks ({block_m}, {block_n}, {block_k}) must "
                         f"divide ({m}, {n}, {k})")
    which = variant(x.dtype, y.dtype, k, n)
    # the reference's kernel multiplies whatever it is given with a
    # float32 accumulator; here the wgmma kernel takes bfloat16 pairs as
    # they are and the ffma kernel everything else in float32
    if which == "ffma":
        x, y = x.float(), y.float()
    if x.device.type == "cpu":
        return matmul_plain(x, y, out_dtype)
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul takes contiguous inputs")
    if (n + 127) // 128 > 65535:
        raise ValueError(f"{(n + 127) // 128} column tiles: at most 65535")
    x, y = build.aligned(x), build.aligned(y)
    kernel_out = out_dtype if out_dtype in _DTYPES else torch.float32
    out = torch.empty(m, n, dtype=kernel_out, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out_bf16 = int(kernel_out == torch.bfloat16)
    if which == "wgmma":
        LIB("matmul_wgmma", x.data_ptr(), y.data_ptr(), out.data_ptr(), m,
            n, k, out_bf16, stream)
        matmul.wgmma_launches += 1
    else:
        LIB("matmul_ffma", x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n,
            k, int(ffma_vec(k, n) == 4), out_bf16, stream)
        matmul.ffma_launches += 1
    matmul.launches += 1
    return out.to(out_dtype)


matmul.launches = 0          # every kernel launch
matmul.wgmma_launches = 0    # of which the bfloat16 tensor-core kernel
matmul.ffma_launches = 0     # of which the float32 FFMA kernel
