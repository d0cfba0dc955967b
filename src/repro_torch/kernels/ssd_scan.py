"""Mamba-2 SSD chunked scan, hand-written.

The SSD chunking of Mamba-2 (arXiv:2405.21060) is the paper's Table 1
MultiFold strip-mining rule applied to the state recurrence: the
sequence fold splits into an intra-chunk pattern (dense products on a
tile) plus an inter-chunk combine (the decayed state carry), with the
chunk state forwarded between strided iterations.

``ssd_scan`` runs the CUDA kernel ``csrc/ssd_scan.cuh`` for CUDA tensors
and its plain PyTorch version, ``ssd_scan_plain``, for CPU tensors.  Each
block of the kernel owns one (batch, head, slice of state columns) and
loops over the chunks itself, carrying the float32 state.  A chunk is
computed as sub-chunks of ``sub_chunk(chunk)`` steps (the state carried
across them), in the kernel and in the plain version alike.
``auto_tile=True`` takes the DSE's chunk for (seq, n, dh)
(``ops.resolve_plan("scan")``) for the tier of the inputs' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ..device import place

LS_MAX = 64          # steps of a sub-chunk, at most
DS_MAX = 16          # state columns of a kernel block, at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// Mamba-2 SSD chunked scan: ssd_scan.cuh's kernel per input type
#include "ssd_scan.cuh"

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               int batch, int seq, int heads, int dh, int n,
                               int ls, int ds, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? ssd::launch<__nv_bfloat16>(x, dt, A, B, C, y, batch, seq,
                                           heads, dh, n, ls, ds, s)
              : ssd::launch<float>(x, dt, A, B, C, y, batch, seq, heads, dh,
                                   n, ls, ds, s);
}

extern "C" int ssd_scan_smem(int ls, int n, int ds, int* bytes) {
  *bytes = ssd::smem_floats(ls, n, ds) * (int)sizeof(float);
  return 0;
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("ssd_scan", SOURCE, {
    "ssd_scan_launch": [_VP] * 6 + [_INT] * 8 + [_VP],
    "ssd_scan_smem": [_INT] * 3 + [_VP]})


def _largest_divisor(n: int, cap: int) -> int:
    return max(c for c in range(1, min(n, cap) + 1) if n % c == 0)


def sub_chunk(chunk: int) -> int:
    """Steps the kernel computes at once: the largest divisor of
    ``chunk`` up to ``LS_MAX``."""
    return _largest_divisor(chunk, LS_MAX)


def _auto_chunk(seq: int, n: int, dh: int, device) -> int:
    from .ops import resolve_plan
    chunk, _ = resolve_plan("scan", seq, n, dh, device=device)
    return chunk


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *,
                   chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``ssd_scan``: the chunked algorithm in
    float32, every (batch, head) at once, looping over sub-chunks of
    ``sub_chunk(chunk)`` steps with the state carried between them."""
    bsz, seq, h, dh = x.shape
    n = B.shape[-1]
    ls = sub_chunk(min(chunk, seq))
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    a = A.float()
    state = torch.zeros((bsz, h, n, dh), device=x.device)
    lower = torch.tril(torch.ones((ls, ls), dtype=torch.bool,
                                  device=x.device))
    ys = []
    for t0 in range(0, seq, ls):
        xc = xf[:, t0:t0 + ls].transpose(1, 2)           # (b, h, L, dh)
        dtc = dtf[:, t0:t0 + ls].transpose(1, 2)         # (b, h, L)
        Bc, Cc = Bf[:, t0:t0 + ls], Cf[:, t0:t0 + ls]    # (b, L, n)
        cum = torch.cumsum(a[None, :, None] * dtc, -1)   # (b, h, L)
        M = torch.where(lower, torch.exp(cum[..., :, None]
                                         - cum[..., None, :])
                        * dtc[..., None, :], 0.0)        # (b, h, L, L)
        scores = (Cc @ Bc.transpose(-1, -2))[:, None]    # (b, 1, L, L)
        y = (scores * M) @ xc + torch.exp(cum)[..., None] * (
            Cc[:, None] @ state)
        ys.append(y.transpose(1, 2))
        w = torch.exp(cum[..., -1:] - cum) * dtc         # (b, h, L)
        state = torch.exp(cum[..., -1])[..., None, None] * state + (
            Bc[:, None] * w[..., None]).transpose(-1, -2) @ xc
    return torch.cat(ys, 1).to(x.dtype)


def _inputs(x, dt, A, B, C, device):
    x, dt, A, B, C = place((x, dt, A, B, C), device)
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}: (batch, seq, heads, dh)")
    bsz, seq, h, _ = x.shape
    if tuple(dt.shape) != (bsz, seq, h) or tuple(A.shape) != (h,) \
            or B.dim() != 3 or tuple(B.shape[:2]) != (bsz, seq) \
            or B.shape != C.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}: dt (batch, seq, heads),"
            f" A (heads,), B and C (batch, seq, n)")
    if not all(t.is_floating_point() for t in (x, dt, A, B, C)):
        raise ValueError(f"ssd_scan takes floating-point inputs, got "
                         f"{x.dtype}, {dt.dtype}, {A.dtype}, {B.dtype}, "
                         f"{C.dtype}")
    # the reference's kernel reads every input as float32 (bfloat16 x, B
    # and C beside float32 dt and A, as Mamba-2's block passes them); here
    # x, dt, B and C all bfloat16 run as they are, any other mix in float32
    if not x.dtype == dt.dtype == B.dtype == C.dtype == torch.bfloat16:
        x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    return x, dt, A, B, C


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, auto_tile: bool = False,
             device=None) -> torch.Tensor:
    """Mamba-2 SSD scan; see ``ref.ssd_scan`` for the semantics.

    x (batch, seq, heads, dh), dt (batch, seq, heads), B and C (batch,
    seq, n) and A (heads,) of any floating types: x, dt, B and C all
    bfloat16 run as they are, any other mix in float32.  The result has
    x's type; the state is float32.  ``chunk`` must divide seq.
    Runs on ``device`` (default: where the tensors are, CUDA for arrays).
    ``auto_tile=True`` replaces the chunk with the DSE plan.  Replaces the
    TPU kernel ``ssd_scan`` (reference kernels/ssd_scan.py)."""
    out_dtype = torch.as_tensor(x).dtype
    x, dt, A, B, C = _inputs(x, dt, A, B, C, device)
    bsz, seq, h, dh = x.shape
    n = B.shape[-1]
    if auto_tile:
        chunk = _auto_chunk(seq, n, dh, x.device)
    chunk = min(chunk, seq)
    if seq % chunk:
        raise ValueError(f"chunk {chunk} must divide seq = {seq}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk).to(out_dtype)
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan takes contiguous inputs")
    if h > 65535 or bsz > 65535:
        raise ValueError(f"grid (., {h}, {bsz}): at most 65535 in y and z")
    ls, ds = sub_chunk(chunk), _largest_divisor(dh, DS_MAX)
    smem = ctypes.c_int(0)
    LIB("ssd_scan_smem", ls, n, ds, ctypes.byref(smem))
    optin = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem.value > optin:
        raise ValueError(f"ssd_scan needs {smem.value} B of shared memory "
                         f"per block at n = {n}; the card allows {optin} B")
    y = torch.empty_like(x)
    LIB("ssd_scan_launch", x.data_ptr(), dt.data_ptr(), A.float().data_ptr(),
        B.data_ptr(), C.data_ptr(), y.data_ptr(), bsz, seq, h, dh, n, ls, ds,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    ssd_scan.launches += 1
    return y.to(out_dtype)


ssd_scan.launches = 0
