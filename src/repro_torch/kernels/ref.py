"""Plain PyTorch oracles of the hand-written kernels in this package.

Each function is the mathematical definition, as the JAX package's
``kernels/ref.py`` writes it: float32 arithmetic, written for clarity,
not speed.  ``ops.*(use_kernel=False)`` returns these; the kernel tests
hold the kernels against them.  What each computes in:

* ``attention`` and ``ssd_scan``: float32, or float64 for float64
  inputs (the float64 oracles of the checks on the card); the result
  has q's (x's) type.
* ``matmul``, ``groupby_fold`` and ``filter_reduce``: float32 whatever
  the inputs, as the reference's do; the result is float32.
"""
from __future__ import annotations

from typing import Optional

import torch


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.float() @ y.float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention oracle.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.
    ``window`` = sliding-window size (Mistral/Mixtral SWA): query i
    attends to keys in (i - window, i].  Queries sit at the tail of the
    keys (position ``i + sk - sq``); a row that sees no key is NaN.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    kq = k.repeat_interleave(group, dim=1).to(ct)
    vq = v.repeat_interleave(group, dim=1).to(ct)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kq) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vq).to(q.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD (state-space duality) oracle -- sequential recurrence.

    x:  (batch, seq, heads, head_dim)
    dt: (batch, seq, heads)        positive step sizes
    A:  (heads,)                   negative decay rates
    B:  (batch, seq, state)        input projection (shared across heads)
    C:  (batch, seq, state)        output projection
    Returns y: (batch, seq, heads, head_dim).

    h_t = exp(A dt_t) h_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t^T h_t
    """
    bsz, seq, h, dh = x.shape
    n = B.shape[-1]
    out_dtype = x.dtype
    ct = torch.promote_types(x.dtype, torch.float32)
    x, dt, A, B, C = (t.to(ct) for t in (x, dt, A, B, C))
    state = torch.zeros((bsz, h, n, dh), dtype=ct, device=x.device)
    ys = []
    for t in range(seq):
        dtt = dt[:, t]                                       # (b, h)
        decay = torch.exp(A * dtt)[:, :, None, None]
        state = state * decay + (dtt[:, :, None, None]
                                 * B[:, t, None, :, None]
                                 * x[:, t, :, None, :])      # (b, h, n, dh)
        ys.append(torch.einsum("bn,bhnd->bhd", C[:, t], state))
    return torch.stack(ys, 1).to(out_dtype)


def groupby_fold(keys: torch.Tensor, values: torch.Tensor,
                 num_keys: int) -> torch.Tensor:
    """Dense keyed sum: out[k] = sum of values[i] with keys[i] == k.
    Keys outside ``[0, num_keys)`` match no row of the one-hot matrix,
    so they are dropped."""
    onehot = (keys.reshape(-1, 1)
              == torch.arange(num_keys, device=keys.device)).float()
    return torch.einsum("ik,i...->k...", onehot, values.float())


def filter_reduce(x: torch.Tensor, lo, hi,
                  weight: torch.Tensor) -> torch.Tensor:
    """TPC-H Q6 shape: sum(weight[i] * x[i]) over lo <= x[i] < hi."""
    pred = (x >= lo) & (x < hi)
    return torch.sum(torch.where(pred, x.float() * weight.float(), 0.0))
