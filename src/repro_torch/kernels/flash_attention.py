"""Flash attention (GQA, causal, optional sliding window), hand-written.

The paper's method applied to attention: strip-mine the softmax
MultiFold over keys, interchange it with the query Map, and keep a
running (max, sum, acc) accumulator forwarded between the strided
iterations -- the paper's accumulator forwarding *is* online softmax.

``flash_attention`` runs the CUDA kernel ``csrc/flash_attention.cuh`` for
CUDA tensors and its plain PyTorch version, ``flash_attention_plain``,
for CPU tensors.  Each block of the kernel owns ``block_q`` query rows of
one head and loops over all keys itself; ``block_k`` is the kv block of
the TPU kernel's online softmax, which the plain version mirrors and the
kernel replaces with its own staging grain (the result is the same up to
rounding).  Masked scores are the finite ``NEG_INF``, as in the TPU
kernel, so a row that sees no key (causal with ``sq > sk``) is the mean
of V, not NaN.  ``auto_tile=True`` takes the DSE's plan for (sq, sk, d)
(``ops.resolve_plan("attention")``) for the tier of the inputs' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from ..device import place

NEG_INF = -1e30
D_MAX = 128          # fa::DMAX: the largest head dim the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = '''// GQA flash attention: flash_attention.cuh's kernel per input type
#include "flash_attention.cuh"

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b,
                                      int hkv, int group, int sq, int sk,
                                      int d, int block_q, float scale,
                                      int causal, int use_window, int window,
                                      int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? fa::launch<__nv_bfloat16>(q, k, v, out, b, hkv, group, sq,
                                          sk, d, block_q, scale, causal,
                                          use_window, window, s)
              : fa::launch<float>(q, k, v, out, b, hkv, group, sq, sk, d,
                                  block_q, scale, causal, use_window, window,
                                  s);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("flash_attention", SOURCE, {
    "flash_attention_launch": [_VP] * 4 + [_INT] * 7 + [ctypes.c_float]
    + [_INT] * 4 + [_VP]})


def _auto_blocks(sq: int, sk: int, d: int, device) -> Tuple[int, int]:
    from .ops import resolve_plan
    blocks, _ = resolve_plan("attention", sq, sk, d, device=device)
    return blocks


def visible_mask(sq: int, sk: int, q0: int, k0: int, rows: int, keys: int,
                 causal: bool, window: Optional[int],
                 device) -> torch.Tensor:
    """Visible (query, key) pairs of rows q0.. and keys k0.. (queries at
    the tail of the keys)."""
    qpos = torch.arange(q0, q0 + rows, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(k0, k0 + keys, device=device)[None, :]
    mask = torch.ones((rows, keys), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: the TPU kernel's
    online softmax over kv blocks of ``block_k`` keys, every (batch, head,
    query row) at once; float32 statistics, masked scores ``NEG_INF``, p
    rounded to V's type before the PV product."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    block_k = min(block_k, sk)
    qf = q.reshape(b, hkv, group, sq, d).float()
    m = torch.full((b, hkv, group, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, :, None, k0:k0 + block_k].float()
        vb = v[:, :, None, k0:k0 + block_k]
        s = (qf @ kb.transpose(-1, -2)) * scale
        mask = visible_mask(sq, sk, 0, k0, sq, kb.shape[-2], causal,
                            window, q.device)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vb.float()
        m = m_new
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom[..., None]).to(q.dtype).reshape(b, hq, sq, d)


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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, auto_tile: bool = False,
                    device=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    GQA: head h reads kv head h // (Hq // Hkv).  Query row i sits at
    position i + Sk - Sq; ``causal`` masks keys after it, ``window`` keys
    at or before ``i - window``.  Inputs of any floating types: three
    bfloat16 inputs run as they are, any other mix in float32; the result
    has q's type.  The blocks must divide Sq and Sk, as the
    TPU kernel requires.  ``block_q`` is the query rows of one CUDA block;
    ``block_k`` sets the kv block of the plain version only: the CUDA
    kernel stages K and V 64 keys at a time whatever ``block_k`` (the
    same result up to rounding).  Runs on ``device`` (default: where the
    tensors are, CUDA for arrays).
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
        block_q, block_k = _auto_blocks(sq, sk, d, q.device)
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
    if group > 65535 or b * hkv > 65535:
        raise ValueError(f"grid ({sq // block_q}, {group}, {b * hkv}): at "
                         f"most 65535 in y and z")
    out = torch.empty_like(q)
    LIB("flash_attention_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hkv, group, sq, sk, d, block_q, float(scale),
        int(causal), int(window is not None),
        0 if window is None else int(window), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out.to(out_dtype)


flash_attention.launches = 0
