"""AdamW with global-norm clipping, a cosine schedule, and optional int8
gradient compression with error feedback (the reference's
``optim/adamw.py`` in PyTorch).

The state is the reference's: float32 moments ``m`` and ``v`` (and the
error-feedback residual ``ef`` with compression) shaped as the
parameters, and an int32 step count.  ``update`` works in place, as the
reference's train step donates its buffers: under ``torch.no_grad()``
each parameter and moment is overwritten, one leaf at a time.  The
clip's global norm is taken in a first pass over the leaves, so the
float32 view of only one gradient is live at a time (at granite-3-2b's
width all of them would be 10 GB).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Tree
    v: Tree
    ef: Optional[Tree] = None   # error-feedback residual (compression)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False  # int8 + error feedback


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def init(params: Tree, cfg: AdamWConfig) -> AdamWState:
    """Zero moments (and residual) on the parameters' devices."""
    dev = next(iter(params.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      _zeros(params), _zeros(params),
                      _zeros(params) if cfg.compress_grads else None)


def state_specs(param_specs: Tree, cfg: AdamWConfig) -> AdamWState:
    """The state's shapes and types as tensors on the ``meta`` device
    (no memory)."""
    def zeros():
        return {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for k, p in param_specs.items()}
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      zeros(), zeros(), zeros() if cfg.compress_grads
                      else None)


def schedule(step: int, cfg: AdamWConfig) -> float:
    """The learning rate at ``step``: linear warm-up on ``(step + 1) /
    warmup_steps`` (``update`` passes the already incremented step, as
    the reference does), then a cosine from 1 to 0.1 of ``lr``."""
    warm = min(1.0, (step + 1) / cfg.warmup_steps)
    prog = min(max((step - cfg.warmup_steps)
                   / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale)."""
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress_with_feedback(grads: Tree, ef: Tree) -> Tuple[Tree, Tree]:
    """int8 round trip with error feedback: returns the dequantized
    gradients and the new residuals (what the round trip lost)."""
    deq, new_ef = {}, {}
    for k, g in grads.items():
        g32 = g.float() + ef[k]
        q, s = quantize_int8(g32)
        deq[k] = dequantize_int8(q, s)
        new_ef[k] = g32 - deq[k]
    return deq, new_ef


def bias_corrections(step: int, cfg: AdamWConfig) -> Tuple[float, float]:
    """``(1 - beta1^step, 1 - beta2^step)`` at the incremented step."""
    return 1 - cfg.beta1 ** step, 1 - cfg.beta2 ** step


@torch.no_grad()
def update(grads: Tree, state: AdamWState, params: Tree,
           cfg: AdamWConfig) -> Tuple[Tree, AdamWState]:
    """One AdamW step, in place: the gradients (any type; taken in the
    moments' type, float32) are clipped to ``clip_norm`` by their global
    norm, then the moments and the parameters are updated leaf by leaf,
    the bias corrections and the schedule at the incremented step, the
    decay applied to the float32 view of the parameter and the result
    cast back to its type.  (A state whose moments are float64 runs the
    same step in float64: the oracle a float32 step is held to.)
    Returns ``(params, state)``, the same tensors."""
    ef = state.ef
    if cfg.compress_grads:
        grads, new_ef = _compress_with_feedback(grads, state.ef)
        for k, e in new_ef.items():
            ef[k].copy_(e)
    acc = next(iter(state.m.values())).dtype
    sq = None
    for g in grads.values():        # one float32 leaf live at a time
        s = torch.sum(torch.square(g.to(acc)))
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)

    state.step.add_(1)
    step = int(state.step)
    lr = schedule(step, cfg)
    b1c, b2c = bias_corrections(step, cfg)
    for k, p in params.items():
        g = grads[k].to(acc) * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
        v.mul_(cfg.beta2).add_(torch.square(g), alpha=1 - cfg.beta2)
        p32 = p.to(acc)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, state


def tree_map(fn, state: AdamWState) -> AdamWState:
    """``state`` with ``fn`` applied to every tensor (a copy to another
    device or type, a clone)."""
    def each(tree: Optional[Tree]) -> Optional[Tree]:
        return None if tree is None else {k: fn(t) for k, t in tree.items()}
    return AdamWState(fn(state.step), each(state.m), each(state.v),
                      each(state.ef))
