"""Mixture-of-experts FFN sublayer, GShard-style grouped dispatch (the
reference's ``models/moe.py`` in PyTorch).

Tokens are split into routing groups of at most ``GROUP_SIZE``; each
group routes its tokens independently to (expert, capacity slot)
positions.  A token's slot is its rank among the group's choices of the
same expert (a stable sort by expert id, then a running maximum of the
segment starts); choices past the expert's capacity are dropped.  The
tokens are scattered into a buffer of ``experts x capacity`` rows with
one dump row that takes the dropped ones, the experts run as batched
products, and each token gathers its rows back (a zero row for a dropped
choice), weighted by its gates.  The routing count is a GroupByFold:
``router_counts`` runs it through ``kernels.ops.groupby``, whose
``use_kernel=True`` path is the ``groupby_fold`` kernel.

Supports Mixtral (8 experts, top-2, every layer) and Llama-4 Maverick
(128 experts, top-1, every other layer, plus a shared expert).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from . import layers as L
from .config import ModelConfig
from .sharding import data_gathered, hint, on_local, pinned, proj_input

GROUP_SIZE = 4096  # tokens per routing group (capacity is per group)


def param_shapes(cfg: ModelConfig, n_moe_layers: int) -> Dict[str, Tuple]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {
        "router": (n_moe_layers, d, e),
        "we1": (n_moe_layers, e, d, f),
        "we3": (n_moe_layers, e, d, f),
        "we2": (n_moe_layers, e, f, d),
    }
    if cfg.shared_expert:
        shapes.update({
            "ws1": (n_moe_layers, d, f),
            "ws3": (n_moe_layers, d, f),
            "ws2": (n_moe_layers, f, d),
        })
    return shapes


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(cfg.capacity_factor * group_tokens * cfg.top_k
              / cfg.n_experts)
    return max(8, min(group_tokens, (cap + 7) // 8 * 8))


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    largest first and the lower index first among equal values (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among ties): a
    stable descending sort."""
    idx = torch.argsort(logits, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return logits.gather(-1, idx), idx


def route(gate_logits: torch.Tensor, cfg: ModelConfig, cap: int):
    """Each group's routing from its float32 gate logits ``(g, t, e)``:
    ``(topi, gates, dest)``, the top-k experts ``(g, t, k)`` (int64),
    their softmax gates, and each choice's flat slot ``expert x cap +
    rank`` in the dispatch buffer, ``e x cap`` (the dump row) where the
    rank reaches ``cap``.  Integer arithmetic only past the top-k."""
    g, t, _ = gate_logits.shape
    k = cfg.top_k
    topv, topi = top_k(gate_logits, k)
    gates = torch.softmax(topv, dim=-1)
    n = t * k
    flat_e = topi.reshape(g, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    idx = torch.arange(n, device=gate_logits.device).expand(g, n)
    is_new = torch.ones((g, n), dtype=torch.bool, device=idx.device)
    is_new[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=1).values
    slot_sorted = idx - seg_start                   # rank in its segment
    inv = torch.argsort(order, dim=1)
    slot = slot_sorted.gather(1, inv).reshape(g, t, k)
    nslots = cfg.n_experts * cap
    dest = torch.where(slot < cap, topi * cap + slot, nslots)
    return topi, gates, dest


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``p`` holds one layer's slices."""
    b, s, d = x.shape
    n_tok = b * s
    gsz = min(GROUP_SIZE, n_tok)
    if n_tok % gsz:
        raise ValueError(f"{n_tok} tokens do not split into routing groups "
                         f"of {gsz}")
    # the groups flatten (B, S): a sharded sequence is gathered first
    xt = hint(proj_input(x).reshape(n_tok // gsz, gsz, d),
              "data", None, None)
    gate_logits = torch.einsum("gtd,de->gte", xt.float(),
                               p["router"].float())
    # routing is integer work per group: on a mesh, each rank routes its
    # own groups (``on_local``), as the reference's data-sharded groups
    cap = capacity(cfg, gsz)
    _, gates, dest = on_local(lambda logits: route(logits, cfg, cap), (0,),
                              gate_logits)
    yt = experts(p, xt, gates, dest, cfg)
    if cfg.shared_expert:
        act = L.activation("silu" if cfg.activation == "swiglu"
                           else cfg.activation)
        hs = act(torch.einsum("gtd,df->gtf", xt, p["ws1"]))
        if cfg.activation == "swiglu":
            hs = hs * torch.einsum("gtd,df->gtf", xt, p["ws3"])
        yt = yt + torch.einsum("gtf,fd->gtd", hs, p["ws2"])
    # pinned: the view's backward flattens (B, S) again
    return pinned(yt.reshape(b, s, d)).to(x.dtype)


def _dispatch(xt: torch.Tensor, dest: torch.Tensor, e: int,
              cap: int) -> torch.Tensor:
    """Scatter dispatch: tokens ``xt`` (g, t, D) into the (g, e, cap, D)
    buffer; each kept (expert, slot) has one writer, dropped choices
    land in a dump row removed after the adds."""
    g, gsz, d = xt.shape
    nslots = e * cap
    rows = nslots + 1
    base = (torch.arange(g, device=xt.device) * rows)[:, None]
    buf = torch.zeros((g * rows, d), dtype=xt.dtype, device=xt.device)
    src = xt.reshape(g * gsz, d)
    for kk in range(dest.shape[-1]):
        buf.index_add_(0, (dest[:, :, kk] + base).reshape(-1), src)
    return buf.reshape(g, rows, d)[:, :nslots].reshape(g, e, cap, d)


def _combine(ex_out: torch.Tensor, gates: torch.Tensor,
             dest: torch.Tensor) -> torch.Tensor:
    """Gather combine: each token's rows of ``ex_out`` (g, e, cap, D)
    weighted by its gates; dropped choices read an appended zero row."""
    g, e, cap, d = ex_out.shape
    _, gsz, k = dest.shape
    nslots = e * cap
    rows = nslots + 1
    base = (torch.arange(g, device=ex_out.device) * rows)[:, None]
    flat = torch.cat([ex_out.reshape(g, nslots, d),
                      torch.zeros((g, 1, d), dtype=ex_out.dtype,
                                  device=ex_out.device)], dim=1)
    got = flat.reshape(g * rows, d)[(dest + base[:, :, None]).reshape(-1)]
    got = got.reshape(g, gsz, k, d)
    return torch.einsum("gtkd,gtk->gtd", got, gates.to(ex_out.dtype))


def experts(p: Dict, xt: torch.Tensor, gates: torch.Tensor,
            dest: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The routed experts of ``moe_ffn`` for one routing (``route``'s
    ``gates`` and ``dest``): tokens ``xt`` (g, t, D) scattered into the
    dispatch buffer, the experts' products, and each token's rows
    gathered back weighted by its gates -> (g, t, D) in ``xt``'s type.
    On a mesh the scatter and the gather run on each rank's groups
    (``on_local``) and the products shard experts over "model"."""
    cap = capacity(cfg, xt.shape[1])
    ex_in = on_local(functools.partial(_dispatch, e=cfg.n_experts,
                                       cap=cap), (0,), xt, dest)
    ex_in = hint(ex_in, "data", "model", None, None)
    act = L.activation("silu" if cfg.activation == "swiglu"
                       else cfg.activation)
    we1, we3, we2 = (data_gathered(p.get(k)) for k in ("we1", "we3", "we2"))
    h = torch.einsum("gecd,edf->gecf", ex_in, we1)
    if cfg.activation == "swiglu":
        h = act(h) * torch.einsum("gecd,edf->gecf", ex_in, we3)
    else:
        h = act(h)
    ex_out = torch.einsum("gecf,efd->gecd", h, we2)
    ex_out = hint(ex_out, "data", "model", None, None)
    return on_local(_combine, (0,), ex_out, gates, dest)


def router_counts(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  use_kernel: bool = False) -> torch.Tensor:
    """Tokens per expert of the top-1 choice: the GroupByFold of MoE
    routing, float32 ``(n_experts,)``.  ``use_kernel`` runs the
    ``groupby_fold`` kernel (its plain version for CPU tensors), else
    the ``ref`` oracle."""
    from ..kernels import ops

    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.float() @ p["router"].float()
    top1 = torch.argmax(logits, dim=-1).to(torch.int32)
    ones = torch.ones((b * s,), dtype=torch.float32, device=x.device)
    return ops.groupby(top1, ones, cfg.n_experts, use_kernel=use_kernel,
                       device=x.device)
