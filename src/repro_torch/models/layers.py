"""Shared building blocks: norms, RoPE, activations, inits, Mamba's
depthwise causal conv and the training loss (the reference's
``models/layers.py`` in PyTorch; its ``scan_layers`` is
``transformer.super_blocks``' loop, and ``remat`` stands where the
reference wraps a layer body in ``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The type a statistic of ``x`` accumulates in: float32, or float64
    for a float64 ``x`` (the float64 runs that hold a float32 step)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def up(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its accumulation type (``acc_dtype``)."""
    return x.to(acc_dtype(x))


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = up(x)
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(x.dtype))).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the Mamba blocks run it: x times the logistic
    ``1 / (1 + exp(-x))``, each operation in x's type (in bfloat16 each
    rounds, as the reference's block does; ``F.silu`` rounds once and
    differs from it by an ulp in a third of the elements).  The dense
    FFN keeps ``F.silu``, which is what the reference's fused serving
    step computes there."""
    return x * (1 / (1 + torch.exp(-x)))


def _squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "squared_relu":          # Nemotron-4 / Primer
        return _squared_relu
    if name == "gelu":
        return _gelu_tanh
    if name == "silu":
        return F.silu
    raise KeyError(name)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) rotary over D; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    acc = acc_dtype(x)
    freqs = theta ** (-torch.arange(0, half, dtype=acc,
                                    device=x.device) / half)
    ang = positions[..., None].to(acc) * freqs               # (..,S,half)
    cos = torch.cos(ang)[..., None, :]                       # (..,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    fan_in = shape[in_axis]
    std = fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    # scaled in place: one float32 temporary (an expert stack at full
    # width is 21 GB of them)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, d) at integer ``tokens``; on a mesh,
    ``sharding.vocab_parallel_embed``."""
    from .sharding import is_dtensor, vocab_parallel_embed

    if is_dtensor(table):
        return vocab_parallel_embed(table, tokens.long())
    return table[tokens.long()]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv (Mamba).  x: (B, S, C); w: (K, C).

    Returns (y, new_state) where state is the last K-1 inputs (zeros
    before the first); y has x's type, each tap's product and sum in
    it, as the reference's."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)                 # (B, S+K-1, C)
    s = x.shape[-2]
    ys = sum(xp[..., i:i + s, :] * w[i] for i in range(k))
    new_state = xp[..., xp.shape[-2] - (k - 1):, :]
    return ys.to(x.dtype), new_state


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The labels' logits.  A DTensor, whose vocab dim may be sharded,
    takes them as a sum over the vocab of the logits where the column is
    the label and zero elsewhere: each rank sums its own columns (no
    gather of the logits), and the sum of one value and zeros is that
    value, so this equals the gather bit for bit."""
    from .sharding import is_dtensor, last_dim_index

    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    col = last_dim_index(logits)
    return torch.where(col == labels[..., None], logits, 0.0).sum(-1)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with a z-loss on lse², accumulated in
    float32 (float64 logits in float64): logits (..., V), integer labels
    (...)."""
    logits = up(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels.long())
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()


def remat(cfg, fn: Callable, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, *args)``, recomputed in the backward when ``cfg.remat``
    and autograd is recording (``torch.utils.checkpoint``, non-reentrant:
    only ``x`` is saved, as the reference's ``jax.checkpoint`` with
    ``nothing_saveable`` saves nothing inside the body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)
