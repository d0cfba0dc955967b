"""Zamba-2-style hybrid: Mamba-2 backbone + a *shared* attention block
(the reference's ``models/hybrid.py`` in PyTorch).

One transformer block's weights (``s_*``) are reused after every
``shared_attn_every`` Mamba layers (arXiv:2411.15242).  Each application
keeps its own KV cache slot.  The decode cache is a nested dict
``{"ssm": {"conv", "ssm"}, "k", "v"}``, updated in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import layers as L
from . import ssm as ssm_mod
from . import transformer as tr
from .config import ModelConfig
from .sharding import hint, project

Params = Dict[str, Any]


def n_attn_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "embed": ((v, d), "embed"),
        "lm_head": ((d, v), "dense"),
        "final_norm": ((d,), "zeros"),
    }
    shapes.update(ssm_mod.block_param_shapes(cfg, cfg.n_layers, "m_"))
    # ONE shared attention + ffn block
    qk, kv = cfg.qk_dim, cfg.kv_dim
    shapes.update({
        "s_ln1": ((d,), "zeros"), "s_ln2": ((d,), "zeros"),
        "s_wq": ((d, qk), "dense"), "s_wk": ((d, kv), "dense"),
        "s_wv": ((d, kv), "dense"), "s_wo": ((qk, d), "dense"),
        "s_w1": ((d, f), "dense"), "s_w2": ((f, d), "dense"),
        "s_w3": ((d, f), "dense"),
    })
    return shapes


def _shared_slice(params: Params) -> Dict:
    return {k[2:]: v for k, v in params.items() if k.startswith("s_")}


def _m_slices(params: Params, layer: int) -> Dict:
    return {k: v[layer] for k, v in params.items() if k.startswith("m_")}


def _shared_block(shared: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, kv_cache=None, cache_index=None):
    a, _ = tr._attn(shared, L.rms_norm(x, shared["ln1"]), cfg, positions,
                    kv_cache=kv_cache, cache_index=cache_index)
    x = x + a
    return x + tr._dense_ffn(shared, L.rms_norm(x, shared["ln2"]), cfg)


def _group(x, params: Params, shared: Dict, g: int, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """Group ``g``: ``shared_attn_every`` Mamba blocks, then the shared
    attention block (recomputed as one in the backward with
    ``cfg.remat``, as the reference's)."""
    every = cfg.shared_attn_every
    for i in range(every):
        x, _ = ssm_mod.block_forward(_m_slices(params, g * every + i), x,
                                     cfg, prefix="m_")
    x = _shared_block(shared, x, cfg, positions)
    return hint(x, "data", "model", None)  # sequence parallelism


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, padded
    vocab) in the model's type."""
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    shared = _shared_slice(params)
    for g in range(n_attn_apps(cfg)):
        x = L.remat(cfg, _group, x, params, shared, g, cfg, positions)
    x = L.rms_norm(x, params["final_norm"])
    return project(x, params["lm_head"])


# ------------------------------------------------------------------ decode
def _kv_shape(cfg: ModelConfig, batch: int, max_len: int) -> Tuple:
    return (n_attn_apps(cfg), batch, cfg.n_kv_heads,
            tr.cache_len(cfg, max_len), cfg.head_dim)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict:
    dt = tr.dtype_of(cfg)
    shp = _kv_shape(cfg, batch, max_len)
    return {
        "ssm": ssm_mod.init_state(cfg, batch, device=device),
        "k": torch.zeros(shp, dtype=dt, device=device),
        "v": torch.zeros(shp, dtype=dt, device=device),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    dt = tr.dtype_of(cfg)
    shp = _kv_shape(cfg, batch, max_len)
    return {
        "ssm": ssm_mod.state_specs(cfg, batch),
        "k": torch.empty(shp, dtype=dt, device="meta"),
        "v": torch.empty(shp, dtype=dt, device="meta"),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, index: int):
    """One decode step of one token (B, 1) at position ``index``: the
    Mamba layers' recurrent steps, each shared-block application
    attending over its own KV slot.  The cache is updated in place;
    returns ``(logits, cache)``."""
    x = L.embed(params["embed"], tokens)
    index = int(index)
    positions = torch.full((1,), index, dtype=torch.int32, device=x.device)
    shared = _shared_slice(params)
    every = cfg.shared_attn_every
    conv, state = cache["ssm"]["conv"], cache["ssm"]["ssm"]
    for g in range(n_attn_apps(cfg)):
        for i in range(every):
            layer = g * every + i
            x, st = ssm_mod.block_forward(
                _m_slices(params, layer), x, cfg,
                state={"conv": conv[layer], "ssm": state[layer]},
                prefix="m_")
            conv[layer] = st["conv"]
            state[layer] = st["ssm"]
        x = _shared_block(shared, x, cfg, positions,
                          kv_cache=(cache["k"][g], cache["v"][g]),
                          cache_index=index)
    x = L.rms_norm(x, params["final_norm"])
    return project(x, params["lm_head"]), cache
