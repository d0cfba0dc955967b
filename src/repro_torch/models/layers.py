"""Shared building blocks: norms, RoPE, activations, inits, and the
layer loop over stacked parameters (the reference's ``models/layers.py``
in PyTorch).

``causal_conv1d`` (Mamba) and ``softmax_xent`` (training) arrive with
the slices that use them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


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
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..,S,half)
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
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def scan_layers(body, carry, xs: Tuple[Dict[str, torch.Tensor], ...]):
    """The reference's ``lax.scan`` over stacked layer parameters as a
    Python loop: ``xs`` is a tuple of dicts (or tensors) whose leading
    axis is the layer; ``body(carry, slice) -> (carry, y)``.  The ``y``
    of every layer is returned as a list (None when ``body`` gives
    None)."""
    def leading(t):
        if isinstance(t, dict):
            return next((leading(v) for v in t.values()), None)
        if isinstance(t, (tuple, list)):
            return next((n for n in map(leading, t) if n is not None), None)
        return t.shape[0]

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(pick(v, i) for v in t)
        return t[i]

    n = leading(xs)
    ys = []
    for i in range(n):
        carry, y = body(carry, pick(xs, i))
        ys.append(y)
    return carry, (ys if ys and ys[0] is not None else None)
