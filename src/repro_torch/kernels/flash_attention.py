"""Flash attention (GQA, causal, optional sliding window), hand-written.

The paper's method applied to attention: strip-mine the softmax
MultiFold over keys, interchange it with the query Map, and keep a
running (max, sum, acc) accumulator forwarded between the strided
iterations -- the paper's accumulator forwarding *is* online softmax.

``flash_attention`` runs a CUDA kernel of ``csrc/flash_attention.cuh``
for CUDA tensors and its plain PyTorch version, ``flash_attention_plain``,
for CPU tensors.  Two kernels, chosen by ``variant``: ``wgmma`` (three
bfloat16 inputs with ``d % 8 == 0``: both products on the tensor cores,
K and V fed by TMA) and ``ffma`` (every other input).  Both take the
``group`` query heads of a kv head as one axis of ``group * sq`` packed
rows, tile it (``launch_plan``), loop each tile over the 64-key chunks
its rows can see (``live_chunks``) and, with too few tiles to fill the
card, split each tile's keys into parts merged by a second, combine
kernel.  ``block_q`` and ``block_k`` keep the TPU kernel's meaning (they
must divide Sq and Sk) and set the plain version's kv block; the
kernels' tiles are their own.  Masked scores are the finite
``NEG_INF``, as in the TPU kernel, so a row that sees no key (causal
with ``sq > sk``) is the mean of V, not NaN.  ``auto_tile=True`` takes
the DSE's plan for (sq, sk, d) (``ops.resolve_plan("attention")``) for
the tier of the inputs' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from ..device import place

NEG_INF = -1e30
D_MAX = 128          # fa::DMAX: the largest head dim the kernels take
BC = 64              # fa::BC: keys per chunk of both kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// GQA flash attention: flash_attention.cuh's kernels per variant and type
#include "flash_attention.cuh"

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* pm,
    float* pl, float* pacc, int b, int hkv, int group, int sq, int sk, int d,
    int tile_rows, float scale, int causal, int use_window, int window,
    int splits, int wgmma, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (wgmma)
    return fa::launch_wgmma(q, k, v, out, pm, pl, pacc, b, hkv, group, sq,
                            sk, d, tile_rows, scale, causal, use_window,
                            window, splits, s);
  return bf16 ? fa::launch_ffma<__nv_bfloat16>(
                    q, k, v, out, pm, pl, pacc, b, hkv, group, sq, sk, d,
                    scale, causal, use_window, window, splits, s)
              : fa::launch_ffma<float>(q, k, v, out, pm, pl, pacc, b, hkv,
                                       group, sq, sk, d, scale, causal,
                                       use_window, window, splits, s);
}

extern "C" int flash_attention_combine(const float* pm, const float* pl,
                                       const float* pacc, void* out,
                                       long long rows, int d, int splits,
                                       int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? splitk::launch_combine<__nv_bfloat16>(pm, pl, pacc, out,
                                                      rows, d, splits, s)
              : splitk::launch_combine<float>(pm, pl, pacc, out, rows, d,
                                              splits, s);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("flash_attention", SOURCE, {
    "flash_attention_launch": [_VP] * 7 + [_INT] * 7 + [ctypes.c_float]
    + [_INT] * 6 + [_VP],
    "flash_attention_combine": [_VP] * 4 + [ctypes.c_longlong] + [_INT] * 3
    + [_VP]})


def _auto_blocks(sq: int, sk: int, d: int, device,
                 **tuning) -> Tuple[int, int]:
    from .ops import resolve_plan
    blocks, _ = resolve_plan("attention", sq, sk, d, device=device,
                             **tuning)
    return blocks


def visible_mask(sq: int, sk: int, q0: int, k0: int, rows: int, keys: int,
                 causal: bool, window: Optional[int],
                 device) -> torch.Tensor:
    """Visible (query, key) pairs of rows q0.. and keys k0.. (queries at
    the tail of the keys)."""
    return _visible(torch.arange(q0, q0 + rows, device=device) + (sk - sq),
                    torch.arange(k0, k0 + keys, device=device), causal,
                    window)


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """Visible (query, key) pairs of query positions ``qpos`` and key
    positions ``kpos``."""
    mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def live_chunks(r0: int, rows: int, sq: int, sk: int, causal: bool,
                window: Optional[int], split: int = 0, splits: int = 1,
                bc: int = BC) -> Tuple[int, int]:
    """``(first, count)``: the chunks of ``bc`` keys that split ``split``
    of ``splits`` of a tile of ``rows`` packed rows from ``r0`` runs (row
    r is query position r % sq + sk - sq), as ``fa::live_chunks``.

    The tile's range is [lo(first position), hi(last position)] of the
    causal and window masks, cut into ``splits`` contiguous parts; a
    chunk outside it adds exactly 0 to every row that sees a key.  A tile
    holding a row that sees no key runs every chunk, so that row is the
    mean of all of V."""
    def lo(qp):
        return max(0, qp - window + 1) if window is not None else 0

    def hi(qp):
        return min(sk - 1, qp) if causal else sk - 1

    qlo, qhi = 0, sq - 1
    if rows < sq and r0 % sq + rows <= sq:
        qlo, qhi = r0 % sq, r0 % sq + rows - 1
    qlo, qhi = qlo + sk - sq, qhi + sk - sq
    first, last = 0, -(-sk // bc) - 1
    if lo(qlo) <= hi(qlo) and lo(qhi) <= hi(qhi):      # every row sees a key
        first, last = lo(qlo) // bc, hi(qhi) // bc
    n = last - first + 1
    begin = first + split * n // splits
    return begin, first + (split + 1) * n // splits - begin


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          block_k: int = 128, skip_masked: bool = False,
                          splits: int = 1,
                          tile_q: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: the TPU kernel's
    online softmax over kv blocks of ``block_k`` keys; float32
    statistics, masked scores ``NEG_INF``, p rounded to V's type before
    the PV product.

    By default every (batch, head, query row) goes at once over every
    block.  The kernels' two further steps are options: ``skip_masked``
    takes the packed rows (``group * sq`` per kv head) in tiles of
    ``tile_q`` and runs each tile over its ``live_chunks`` only;
    ``splits`` > 1 cuts each tile's blocks into that many parts, each its
    own (m, l, acc), merged in order as the combine kernel merges them."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    rows_total = hq // hkv * sq
    scale = scale if scale is not None else d ** -0.5
    block_k = min(block_k, sk)
    nblocks = -(-sk // block_k)
    if not (skip_masked or splits > 1):
        tile_q = rows_total
    qf = q.reshape(b, hkv, rows_total, d).float()
    out = torch.empty((b, hkv, rows_total, d), device=q.device)
    for r0 in range(0, rows_total, tile_q):
        rows = min(tile_q, rows_total - r0)
        qt = qf[:, :, r0:r0 + rows]
        qpos = torch.arange(r0, r0 + rows, device=q.device) % sq + sk - sq
        parts = []
        for split in range(splits):
            if skip_masked:
                first, count = live_chunks(r0, rows, sq, sk, causal, window,
                                           split, splits, block_k)
            else:
                first = split * nblocks // splits
                count = (split + 1) * nblocks // splits - first
            m = torch.full((b, hkv, rows), NEG_INF, device=q.device)
            l = torch.zeros((b, hkv, rows), device=q.device)
            acc = torch.zeros((b, hkv, rows, d), device=q.device)
            for c in range(first, first + count):
                kb = k[:, :, c * block_k:(c + 1) * block_k].float()
                vb = v[:, :, c * block_k:(c + 1) * block_k]
                kpos = torch.arange(c * block_k, c * block_k + kb.shape[2],
                                    device=q.device)
                s = torch.where(_visible(qpos, kpos, causal, window),
                                (qt @ kb.transpose(-1, -2)) * scale, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] \
                    + p.to(v.dtype).float() @ vb.float()
                m = m_new
            parts.append((m, l, acc))
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        l = torch.zeros_like(mx)
        acc = torch.zeros_like(parts[0][2])
        for m, lp, ap in parts:
            a = torch.exp(m - mx)
            l = l + lp * a
            acc = acc + ap * a[..., None]
        out[:, :, r0:r0 + rows] = acc / torch.where(l == 0.0, 1.0,
                                                     l)[..., None]
    return out.to(q.dtype).reshape(b, hq, sq, d)


def _inputs(q, k, v, device):
    q, k, v = place((q, k, v), device)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: (B, Hq, Sq, D) and (B, Hkv, Sk, "
                         f"D) with Hkv dividing Hq")
    if not all(t.is_floating_point() for t in (q, k, v)):
        raise ValueError(f"flash_attention takes floating-point inputs, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    # the reference's kernel takes any floating types (float32 scores, p
    # rounded to V's type); here three bfloat16 inputs run as they are and
    # any other mix in float32
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    return q, k, v


def variant(q_dtype: torch.dtype, k_dtype: torch.dtype,
            v_dtype: torch.dtype, d: int) -> str:
    """The kernel attention over inputs of these types and head dim
    ``d`` runs: ``"wgmma"`` for three bfloat16 inputs whose rows are
    whole 16-byte pieces (``d % 8 == 0``: TMA's stride rule), else
    ``"ffma"``."""
    if q_dtype == k_dtype == v_dtype == torch.bfloat16 and d % 8 == 0:
        return "wgmma"
    return "ffma"


def launch_plan(b: int, hkv: int, group: int, sq: int, sk: int,
                which: str, sms: int) -> Tuple[int, int, int]:
    """``(tile_q, tiles, splits)`` of a launch on a card of ``sms`` SMs:
    the packed rows per block (128 for wgmma when there are more than
    64, else 64), the tiles per kv head, and how many parts each tile's
    keys are split into.  When ``b * hkv * tiles`` blocks are under two
    per SM, the keys split into enough parts for four blocks per SM (at
    most one part per chunk)."""
    rows = group * sq
    tile_q = 128 if which == "wgmma" and rows > 64 else 64
    tiles = -(-rows // tile_q)
    ctas = b * hkv * tiles
    splits = 1
    if ctas < 2 * sms:
        splits = min(-(-4 * sms // ctas), -(-sk // BC))
    return tile_q, tiles, splits


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, auto_tile: bool = False,
                    device=None, measure: Optional[str] = None,
                    policy=None, options=None,
                    cache=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    GQA: head h reads kv head h // (Hq // Hkv).  Query row i sits at
    position i + Sk - Sq; ``causal`` masks keys after it, ``window`` keys
    at or before ``i - window``.  Inputs of any floating types: three
    bfloat16 inputs run as they are, any other mix in float32; the result
    has q's type.  The blocks must divide Sq and Sk, as the TPU kernel
    requires; ``block_k`` sets the plain version's kv block.  The CUDA
    kernels tile the packed rows and stage keys 64 at a time whatever
    the blocks (``launch_plan``; the same result up to rounding).  Runs
    on ``device`` (default: where the tensors are, CUDA for arrays).
    ``auto_tile=True`` replaces the blocks with the DSE plan.  Replaces
    the TPU kernel ``flash_attention`` (reference
    kernels/flash_attention.py)."""
    out_dtype = torch.as_tensor(q).dtype
    q, k, v = _inputs(q, k, v, device)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if auto_tile:
        block_q, block_k = _auto_blocks(sq, sk, d, q.device,
                                        measure=measure, policy=policy,
                                        options=options, cache=cache)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) must divide "
                         f"(sq, sk) = ({sq}, {sk})")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale,
                                     block_k=block_k).to(out_dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous inputs")
    if d > D_MAX:
        raise ValueError(f"head dim {d}: the kernel takes at most {D_MAX}")
    if b * hkv > 65535:
        raise ValueError(f"{b * hkv} (batch, kv head) pairs: at most 65535")
    which = variant(q.dtype, k.dtype, v.dtype, d)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tile_q, _, splits = launch_plan(b, hkv, group, sq, sk, which, sms)
    if which == "wgmma":
        q, k, v = (build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    rows = b * hq * sq
    parts = [0, 0, 0]
    if splits > 1:
        pm = torch.empty((splits, rows), device=q.device)
        pl = torch.empty((splits, rows), device=q.device)
        pacc = torch.empty((splits, rows, d), device=q.device)
        parts = [pm.data_ptr(), pl.data_ptr(), pacc.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = _DTYPES[q.dtype]
    LIB("flash_attention_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *parts, b, hkv, group, sq, sk, d, tile_q,
        float(scale), int(causal), int(window is not None),
        0 if window is None else int(window), splits,
        int(which == "wgmma"), bf16, stream)
    flash_attention.launches += 1
    if which == "wgmma":
        flash_attention.wgmma_launches += 1
    else:
        flash_attention.ffma_launches += 1
    if splits > 1:
        LIB("flash_attention_combine", *parts, out.data_ptr(), rows, d,
            splits, bf16, stream)
        flash_attention.combine_launches += 1
    return out.to(out_dtype)


flash_attention.launches = 0          # every attention kernel launch
flash_attention.wgmma_launches = 0    # of which the bfloat16 wgmma kernel
flash_attention.ffma_launches = 0     # of which the FFMA kernel
flash_attention.combine_launches = 0  # launches of the split combine
