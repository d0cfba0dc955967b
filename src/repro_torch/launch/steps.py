"""Train, prefill and serve steps and the input specs of every
(architecture x shape) cell (the reference's ``launch/steps.py``).

PyTorch runs eagerly, so each ``make_*`` returns a plain function where
the reference returns one to ``jax.jit``.  The serve steps update the
cache they are handed in place and return it, and the train step its
parameters and optimizer state (the reference's steps donate them).
Gradients come from ``torch.autograd``: the reference's forward has no
custom derivative, and neither has the port's (attention in plain
PyTorch, ``transformer._sdpa_chunked``).  The steps take DTensors as
they take tensors: ``launch.dryrun`` runs them on ``meta`` shards of a
production mesh, and a meshed train step on the card places its
parameters by ``launch.shard_rules``, under ``models.sharding.
use_mesh_hints``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.shapes import ShapeConfig
from ..core import telemetry
from ..models import model
from ..models.config import ModelConfig
from ..models.sharding import is_dtensor
from ..models.transformer import check_family
from ..optim import adamw


def _spec(shape, dtype) -> torch.Tensor:
    """A shape and type record: a tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Stand-ins (``meta`` tensors, no memory) for every model input.

    train/prefill: the token batch (codebook frames for audio; the VLM's
    text after its ``frontend_tokens`` prefix rows, which come as
    bfloat16 ``prefix_embeds``), and the labels for train.  decode: one
    new token a row; the cache and the position are
    ``decode_extras``."""
    gb, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.n_codebooks:
            toks = _spec((gb, s, cfg.n_codebooks), i32)
        elif cfg.family == "vlm":
            toks = _spec((gb, s - cfg.frontend_tokens), i32)
        else:
            toks = _spec((gb, s), i32)
        out = {"tokens": toks}
        if cfg.family == "vlm":
            out["prefix_embeds"] = _spec(
                (gb, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            out["labels"] = _spec(toks.shape, i32)
        return out
    if cfg.n_codebooks:
        return {"tokens": _spec((gb, 1, cfg.n_codebooks), i32)}
    return {"tokens": _spec((gb, 1), i32)}


def decode_extras(cfg: ModelConfig, shape: ShapeConfig):
    """The decode step's other inputs: the cache's specs and the scalar
    int32 position."""
    cache = model.cache_specs(cfg, shape.global_batch, shape.seq_len)
    return cache, _spec((), torch.int32)


def _on(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(params, cfg: ModelConfig, batch: Dict):
    """``(loss, grads)`` of ``model.loss`` by ``torch.autograd``: grads
    a dict like ``params``, in their types.  A parameter the loss does
    not read (Zamba-2's shared ``w3`` under gelu) gets zeros, as
    ``jax.grad`` gives it."""
    names = sorted(params)
    leaves = [params[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = model.loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def _accumulator(param: torch.Tensor, sharding) -> torch.Tensor:
    """A float32 zero gradient accumulator for ``param``: plain, or, for
    a DTensor parameter, a DTensor of local zeros placed by ``sharding``
    (a ``shard_rules.Sharding``) or else as the parameter."""
    if not is_dtensor(param):
        return torch.zeros(param.shape, dtype=torch.float32,
                           device=param.device)
    from torch.distributed.tensor import DTensor

    if sharding is None:
        place, shape = param.placements, param.to_local().shape
    else:
        place, shape = sharding.placements, sharding.shard_shape(param.shape)
    return DTensor.from_local(
        torch.zeros(shape, dtype=torch.float32, device=param.device),
        param.device_mesh, place, run_check=False, shape=param.shape,
        stride=param.stride())


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, grad_shardings=None):
    """``(params, opt_state, batch) -> (loss, params, opt_state)``: the
    loss's gradients by ``torch.autograd`` and one ``adamw.update``, in
    place.  With ``microbatches`` the batch's rows split into that many
    slices, run one after the other; their gradients are summed in
    float32 accumulators and their losses in float32, both divided by
    ``microbatches``, as the reference's.  ``cfg.remat`` recomputes
    each super-block in the backward (``layers.remat``).
    ``grad_shardings`` (name -> ``shard_rules.Sharding``, as the
    parameters') pins the float32 accumulators of DTensor parameters:
    each is made with those placements, and each microbatch's gradient
    is redistributed to them before it is added (the reference's
    ``with_sharding_constraint`` on the carried accumulators).  Without
    it, or with plain tensors, the step is unchanged."""
    with telemetry.span("steps.build.train", family=cfg.family,
                        microbatches=microbatches):
        check_family(cfg)
        shardings = grad_shardings or {}

        def pin(name: str, g: torch.Tensor) -> torch.Tensor:
            sh = shardings.get(name)
            if (sh is None or not is_dtensor(g)
                    or tuple(g.placements) == sh.placements):
                return g
            return g.redistribute(g.device_mesh, sh.placements)

        def train_step(params, opt_state, batch):
            names = sorted(params)
            dev = params[names[0]].device
            batch = _on(batch, dev)
            if microbatches == 1:
                loss, grads = value_and_grad(params, cfg, batch)
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % microbatches:
                    raise ValueError(f"batch of {rows} rows does not split "
                                     f"into {microbatches} microbatches")
                per = rows // microbatches
                grads = {n: _accumulator(params[n], shardings.get(n))
                         for n in names}
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(microbatches):
                    mslice = {k: v[i * per:(i + 1) * per]
                              for k, v in batch.items()}
                    l, g = value_and_grad(params, cfg, mslice)
                    loss = loss + l
                    for n in names:
                        grads[n] += pin(n, g[n].float())
                    del g
                loss = loss / microbatches
                for n in names:
                    grads[n] /= microbatches
            params, opt_state = adamw.update(grads, opt_state, params,
                                             opt_cfg)
            return loss, params, opt_state

        return train_step


def make_prefill_step(cfg: ModelConfig):
    """``(params, batch) -> logits of the last position`` (the serving
    prefill hands only those to decode)."""
    with telemetry.span("steps.build.prefill", family=cfg.family):
        check_family(cfg)

        @torch.no_grad()
        def prefill_step(params, batch):
            return model.forward(params, cfg, batch)[:, -1]

        return prefill_step


def greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The greedy next token of the last position, int32 (the first of
    tied maxima, as ``jnp.argmax`` picks it); pad vocab never wins.
    ``(B,)``, or ``(B, n_cb)`` for codebook logits (one token a
    codebook)."""
    from ..models.sharding import unsharded

    logits = unsharded(model.mask_vocab_pad(logits, cfg)[:, -1], -1)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig):
    """``(params, cache, tokens (B, S[, n_cb]), index) -> (next,
    cache)``: one decode step (or block) and the greedy token after
    it."""
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
