"""Unified model API (the reference's ``models/model.py``), dense and
MoE families:

    shapes  = model.param_shapes(cfg)
    params  = model.init_params(cfg, seed, device)
    logits  = model.forward(params, cfg, batch)
    logits, cache = model.decode_step(params, cfg, cache, tokens, idx)

The SSM, hybrid, audio and VLM families raise ``NotImplementedError``
until ROADMAP §1 step 4.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import transformer as tr
from .config import ModelConfig

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


def param_shapes(cfg: ModelConfig):
    return tr.param_shapes(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    return tr.init_params(cfg, seed, device)


def forward(params: Params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    return tr.forward(params, cfg, batch["tokens"])


def mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pad vocab columns never win: masked to -1e30 (exact for both
    softmax-xent and argmax decode)."""
    if cfg.vocab_pad == 0:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col >= cfg.vocab,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device), logits)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    return tr.init_cache(cfg, batch, max_len, device=device)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    return tr.cache_specs(cfg, batch, max_len)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, index: int):
    return tr.decode_step(params, cfg, cache, tokens, index)
