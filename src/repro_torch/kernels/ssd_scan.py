"""Mamba-2 SSD chunked scan, hand-written.

The SSD chunking of Mamba-2 (arXiv:2405.21060) is the paper's Table 1
MultiFold strip-mining rule applied to the state recurrence: the
sequence fold splits into an intra-chunk pattern (dense products on a
tile) plus an inter-chunk combine (the decayed state carry), with the
chunk state forwarded between strided iterations.

``ssd_scan`` runs the CUDA kernels of ``csrc/ssd_scan.cuh`` for CUDA
tensors and their plain PyTorch version, ``ssd_scan_plain``, for CPU
tensors.  Both compute the chunked SSD's parallel form in four passes
(``PASSES``): the scores ``C Bᵀ`` once per (batch, chunk) (the kernel
also writes each chunk's cumsum of A dt there), the chunk states
``(B ∘ w)ᵀ x`` per (batch, head, chunk), the carry across chunks (the
only serial pass), and the output.  The chunk is computed whole;
the kernels tile it in rows of ``TILE`` and steps of ``SLAB``
(``layout``).  ``auto_tile=True`` takes the DSE's chunk for (seq, n, dh)
(``ops.resolve_plan("scan")``) for the tier of the inputs' device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from ..device import place

TILE = 64            # rows (and columns) of a kernel block's output tile
SLAB = 32            # steps of K a block stages at once
PASSES = ("scores", "states", "carry", "output")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// Mamba-2 SSD chunked scan: ssd_scan.cuh's passes per input type
#include "ssd_scan.cuh"

extern "C" int ssd_scan_pass(int pass, const void* x, const void* dt,
                             const void* A, const void* B, const void* C,
                             void* y, void* G, void* S, void* decay,
                             void* cum, void* dtc, int batch, int seq,
                             int heads, int dh, int n, int L, int bf16,
                             int vec, void* stream) {
  const ssd::Args a{x, dt, (const float*)A, B, C, y, (float*)G, (float*)S,
                    (float*)decay, (float*)cum, (float*)dtc, batch, seq,
                    heads, dh, n, L, seq / L};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return vec ? ssd::launch_pass<__nv_bfloat16, true>(pass, a, s)
               : ssd::launch_pass<__nv_bfloat16, false>(pass, a, s);
  return vec ? ssd::launch_pass<float, true>(pass, a, s)
             : ssd::launch_pass<float, false>(pass, a, s);
}

extern "C" int ssd_scan_smem(int L, int* bytes) {
  *bytes = ssd::smem_bytes(L);
  return 0;
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("ssd_scan", SOURCE, {
    "ssd_scan_pass": [_INT] + [_VP] * 11 + [_INT] * 8 + [_VP],
    "ssd_scan_smem": [_INT, _VP]})


class Layout(NamedTuple):
    """How the kernels cut one chunk: ``row_tiles`` (first row, rows) of
    the scores and output blocks, the ``slabs`` (first step, steps) in
    which the states and intra-chunk products walk it, and a block's
    shared bytes."""
    row_tiles: tuple
    slabs: tuple
    smem_bytes: int


def layout(chunk: int) -> Layout:
    """The kernels' cut of a chunk of ``chunk`` steps (``ssd::smem_bytes``:
    two ring slots of two raw operands of TILE x (SLAB + 4) words, two
    float32 operand tiles of SLAB x TILE, and cum, dt and w)."""
    def cut(step):
        return tuple((i, min(step, chunk - i)) for i in range(0, chunk, step))
    raw = TILE * (SLAB + 4) * 4
    return Layout(cut(TILE), cut(SLAB),
                  4 * raw + 2 * SLAB * TILE * 4 + 3 * chunk * 4)


def workspace_bytes(bsz: int, seq: int, h: int, dh: int, n: int,
                    chunk: int) -> dict:
    """Bytes of the kernels' float32 workspaces: the scores (batch,
    chunks, L, L), the states (batch, heads, chunks, n, dh), the chunks'
    decays (batch, heads, chunks), and each chunk's cumsum of A dt and
    its dt (batch, heads, chunks, L)."""
    nc = seq // chunk
    return {"scores": 4 * bsz * nc * chunk * chunk,
            "states": 4 * bsz * h * nc * n * dh, "decay": 4 * bsz * h * nc,
            "cum": 4 * bsz * h * seq, "dt": 4 * bsz * h * seq}


def _auto_chunk(seq: int, n: int, dh: int, device, **tuning) -> int:
    from .ops import resolve_plan
    chunk, _ = resolve_plan("scan", seq, n, dh, device=device, **tuning)
    return chunk


# ------------------------------------------------------- the plain version
# Each pass computes in float32, or in float64 for float64 inputs.
def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, chunk: int):
    """dt as (batch, chunks, heads, L) and its cumsum over each chunk (A
    dt rounded, then summed)."""
    bsz, seq, h = dt.shape
    dtc = _wide(dt).reshape(bsz, seq // chunk, chunk, h).transpose(2, 3)
    return dtc, torch.cumsum(A.to(dtc.dtype)[:, None] * dtc, -1)


def plain_scores(B: torch.Tensor, C: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Pass 1: ``C Bᵀ`` once per (batch, chunk): (batch, chunks, L, L)."""
    bsz, seq, n = B.shape
    Bc, Cc = (_wide(t).reshape(bsz, seq // chunk, chunk, n) for t in (B, C))
    return Cc @ Bc.transpose(-1, -2)


def plain_states(x, dt, A, B, chunk: int):
    """Pass 2: each chunk's state ``(B ∘ w)ᵀ x`` from a zero state,
    (batch, heads, chunks, n, dh), and its decay ``exp(cum_L)``,
    (batch, heads, chunks)."""
    bsz, seq, h, dh = x.shape
    n = B.shape[-1]
    nc = seq // chunk
    dtc, cum = chunk_cumsum(dt, A, chunk)                  # (b, nc, h, L)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    Bc = _wide(B).reshape(bsz, nc, 1, chunk, n)
    xc = _wide(x).reshape(bsz, nc, chunk, h, dh).transpose(2, 3)
    S = (Bc * w[..., None]).transpose(-1, -2) @ xc         # (b, nc, h, n, dh)
    return S.transpose(1, 2), torch.exp(cum[..., -1]).transpose(1, 2)


def plain_carry(S: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Pass 3: the state entering each chunk, ``h_{c-1}``, with
    ``h_c = exp(cum_L) h_{c-1} + S_c``, serial over the chunks."""
    h = torch.zeros_like(S[:, :, 0])
    out = []
    for c in range(S.shape[2]):
        out.append(h)
        h = decay[:, :, c, None, None] * h + S[:, :, c]
    return torch.stack(out, 2)


def plain_output(x, dt, A, C, scores, h_prev, chunk: int) -> torch.Tensor:
    """Pass 4: ``(G ∘ M) x + exp(cum) ∘ (C h_{c-1})`` per (batch, chunk,
    head): (batch, seq, heads, dh)."""
    bsz, seq, h, dh = x.shape
    n = C.shape[-1]
    nc = seq // chunk
    dtc, cum = chunk_cumsum(dt, A, chunk)                  # (b, nc, h, L)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    M = torch.where(lower, torch.exp(cum[..., :, None] - cum[..., None, :])
                    * dtc[..., None, :], 0.0)              # (b, nc, h, L, L)
    xc = _wide(x).reshape(bsz, nc, chunk, h, dh).transpose(2, 3)
    Cc = _wide(C).reshape(bsz, nc, 1, chunk, n)
    y = (scores[:, :, None] * M) @ xc + torch.exp(cum)[..., None] * (
        Cc @ h_prev.transpose(1, 2))                       # (b, nc, h, L, dh)
    return y.transpose(2, 3).reshape(bsz, seq, h, dh)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *,
                   chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``ssd_scan``: the kernels' four passes in
    float32 (float64 for float64 inputs) -- scores per (batch, chunk),
    chunk states, the carry, the output -- every (batch, chunk, head) at
    once but the carry."""
    chunk = min(chunk, x.shape[1])
    S, decay = plain_states(x, dt, A, B, chunk)
    y = plain_output(x, dt, A, C, plain_scores(B, C, chunk),
                     plain_carry(S, decay), chunk)
    return y.to(x.dtype)


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
             device=None, measure: Optional[str] = None, policy=None,
             options=None, cache=None) -> torch.Tensor:
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
        chunk = _auto_chunk(seq, n, dh, x.device, measure=measure,
                            policy=policy, options=options, cache=cache)
    chunk = min(chunk, seq)
    if seq % chunk:
        raise ValueError(f"chunk {chunk} must divide seq = {seq}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk).to(out_dtype)
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan takes contiguous inputs")
    if h > 65535:
        raise ValueError(f"grid (., {h}): at most 65535 heads")
    smem = ctypes.c_int(0)
    LIB("ssd_scan_smem", chunk, ctypes.byref(smem))
    if smem.value != layout(chunk).smem_bytes:
        raise RuntimeError(f"ssd_scan_smem {smem.value} B != layout's "
                           f"{layout(chunk).smem_bytes} B")
    optin = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem.value > optin:
        raise ValueError(f"ssd_scan needs {smem.value} B of shared memory "
                         f"per block at chunk {chunk}; the card allows "
                         f"{optin} B")
    A = A.float().contiguous()
    ws = workspace_bytes(bsz, seq, h, dh, n, chunk)
    G, S, decay, cum, dtc = (torch.empty(v // 4, device=x.device)
                             for v in ws.values())
    y = torch.empty_like(x)
    size = x.element_size()
    vec = int(n * size % 16 == 0 and dh * size % 16 == 0 and chunk % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, B, C, y)))
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), G.data_ptr(), S.data_ptr(),
            decay.data_ptr(), cum.data_ptr(), dtc.data_ptr(), bsz, seq, h,
            dh, n, chunk, _DTYPES[x.dtype], vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    for i, name in enumerate(PASSES):
        LIB("ssd_scan_pass", i, *args)
        ssd_scan.pass_launches[name] += 1
    ssd_scan.launches += 1
    return y.to(out_dtype)


ssd_scan.launches = 0
ssd_scan.pass_launches = dict.fromkeys(PASSES, 0)
