"""Serve steps (the reference's ``launch/steps.py``): one decode step,
and the cache prefill of a whole prompt (a block for the attention
families, a token scan for the recurrent ones).

PyTorch runs eagerly, so each ``make_*`` returns a plain function where
the reference returns one to ``jax.jit``; the cache it is handed is
updated in place and returned (the reference's steps donate it).  The
train and dry-run steps wait for the training and distribution slices
(ROADMAP §1 items 4 and 5).
"""
from __future__ import annotations

import torch

from ..core import telemetry
from ..models import model
from ..models.config import ModelConfig
from ..models.transformer import check_family


def greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The greedy next token of the last position, int32 (the first of
    tied maxima, as ``jnp.argmax`` picks it); pad vocab never wins."""
    logits = model.mask_vocab_pad(logits, cfg)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig):
    """``(params, cache, tokens (B, S), index) -> (next, cache)``: one
    decode step (or block) and the greedy token after it."""
    with telemetry.span("steps.build.serve", family=cfg.family):
        check_family(cfg)

        def serve_step(params, cache, tokens, index):
            logits, cache = model.decode_step(params, cfg, cache, tokens,
                                              index)
            return greedy(logits, cfg), cache

        return serve_step


def make_cache_prefill_step(cfg: ModelConfig):
    """Prefill a whole prompt block into the decode cache in one call:
    ``(params, cache, tokens (B, S), index) -> (next, cache)`` with
    ``next`` the greedy token after the final prompt position.

    The attention families run the block through ``decode_step``
    directly (S tokens written to the cache contiguously, causal within
    the block); it must not wrap the KV ring buffer
    (``launch.serve._prefill`` chunks long prompts).  The recurrent
    families (SSM, hybrid) carry per-token state, so the block scans
    token by token through ``decode_step``, as the reference's does
    (not through ``ssm.ssd_chunked``), so that its tokens match."""
    with telemetry.span("steps.build.cache_prefill", family=cfg.family):
        check_family(cfg)
        if cfg.family not in ("ssm", "hybrid"):
            return make_serve_step(cfg)

        def prefill_cache_step(params, cache, tokens, index):
            logits = None
            for i in range(tokens.shape[1]):
                logits, cache = model.decode_step(
                    params, cfg, cache, tokens[:, i:i + 1], int(index) + i)
            return greedy(logits, cfg), cache

        return prefill_cache_step
