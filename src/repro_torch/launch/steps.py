"""Serve steps (the reference's ``launch/steps.py``), for the block
path of the attention families.

PyTorch runs eagerly, so each ``make_*`` returns a plain function where
the reference returns one to ``jax.jit``; the cache it is handed is
updated in place and returned (the reference's steps donate it).  The
train, prefill and dry-run steps wait for ROADMAP §1 steps 7 and 8.
"""
from __future__ import annotations

import torch

from ..core import telemetry
from ..models import model
from ..models.config import ModelConfig
from ..models.transformer import check_dense


def greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The greedy next token of the last position, int32 (the first of
    tied maxima, as ``jnp.argmax`` picks it); pad vocab never wins."""
    logits = model.mask_vocab_pad(logits, cfg)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig):
    """``(params, cache, tokens (B, S), index) -> (next, cache)``: one
    decode step (or block) and the greedy token after it."""
    with telemetry.span("steps.build.serve", family=cfg.family):
        check_dense(cfg)

        def serve_step(params, cache, tokens, index):
            logits, cache = model.decode_step(params, cfg, cache, tokens,
                                              index)
            return greedy(logits, cfg), cache

        return serve_step


def make_cache_prefill_step(cfg: ModelConfig):
    """Prefill a whole prompt block into the decode cache in one call:
    ``(params, cache, tokens (B, S), index) -> (next, cache)`` with
    ``next`` the greedy token after the final prompt position.  For the
    attention families this is the serve step itself: the block runs
    through ``decode_step`` (S tokens written to the cache contiguously,
    causal within the block); it must not wrap the KV ring buffer
    (``launch.serve._prefill`` chunks long prompts).  The recurrent
    families' token scan waits for ROADMAP §1 step 4."""
    with telemetry.span("steps.build.cache_prefill", family=cfg.family):
        return make_serve_step(cfg)
