"""Unified model API (the reference's ``models/model.py``): the dense,
MoE, SSM (Mamba-2), hybrid (Zamba-2), audio (MusicGen: multi-codebook
embeddings and heads) and VLM (InternVL: prefix embeddings) families
behind one interface.

    shapes  = model.param_shapes(cfg)
    specs   = model.param_specs(cfg)
    params  = model.init_params(cfg, seed, device)
    logits  = model.forward(params, cfg, batch)
    loss    = model.loss(params, cfg, batch)
    logits, cache = model.decode_step(params, cfg, cache, tokens, idx)
"""
from __future__ import annotations

from typing import Dict

import torch

from . import hybrid as hy
from . import layers as L
from . import ssm as ssm_mod
from . import transformer as tr
from .config import ModelConfig
from .sharding import hint_first, last_dim_index, project

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]

_RECURRENT = ("ssm", "hybrid")


def param_shapes(cfg: ModelConfig):
    tr.check_family(cfg)
    if cfg.family == "ssm":
        d, v = cfg.d_model, cfg.padded_vocab
        shapes = {
            "embed": ((v, d), "embed"),
            "lm_head": ((d, v), "dense"),
            "final_norm": ((d,), "zeros"),
        }
        shapes.update(ssm_mod.block_param_shapes(cfg, cfg.n_layers, "m_"))
        return shapes
    if cfg.family == "hybrid":
        return hy.param_shapes(cfg)
    return tr.param_shapes(cfg)


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A parameter's type: the Mamba blocks' ``A_log``, ``D`` and
    ``dt_bias`` are float32, everything else the config's type."""
    if name.startswith("m_") and name[2:] in ssm_mod.FLOAT32_PARAMS:
        return torch.float32
    return tr.dtype_of(cfg)


def param_specs(cfg: ModelConfig) -> Params:
    """The parameters' shapes and types as tensors on the ``meta``
    device (no memory), as ``steps.input_specs`` gives the inputs'."""
    return {name: torch.empty(shape, dtype=param_dtype(cfg, name),
                              device="meta")
            for name, (shape, _) in param_shapes(cfg).items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, drawn in sorted parameter order (other numbers than the
    reference's ``jax.random`` gives); the Mamba decays start stable as
    the reference's (``A_log`` = -0.5: A in [-e, -1/e])."""
    if cfg.family not in _RECURRENT:
        return tr.init_params(cfg, seed, device)
    from ..device import resolve

    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shape, kind) in sorted(param_shapes(cfg).items()):
        dt = param_dtype(cfg, name)
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=dev)
        elif kind == "embed":
            out[name] = L.embed_init(gen, shape, dt, dev)
        else:
            in_axis = -2 if len(shape) >= 2 else 0
            out[name] = L.dense_init(gen, shape, in_axis, dt, dev)
    out["m_A_log"].fill_(-0.5)
    return out


def _ssm_body(x, slc, cfg: ModelConfig):
    return ssm_mod.block_forward(slc, x, cfg, prefix="m_")[0]


def _ssm_forward(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed(params["embed"], tokens)
    for layer in range(cfg.n_layers):
        slc = {k: v[layer] for k, v in params.items() if k.startswith("m_")}
        x = L.remat(cfg, _ssm_body, x, slc, cfg)
    x = L.rms_norm(x, params["final_norm"])
    return project(x, params["lm_head"])


def forward(params: Params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    """Logits of ``batch["tokens"]``; the VLM puts the batch's
    ``prefix_embeds`` (B, P, d), when it has them, ahead of its tokens."""
    tokens = batch["tokens"]
    tr.check_family(cfg)
    if cfg.family == "ssm":
        return _ssm_forward(params, cfg, tokens)
    if cfg.family == "hybrid":
        return hy.forward(params, cfg, tokens)
    if cfg.family == "vlm":
        return tr.forward(params, cfg, tokens,
                          prefix_embeds=batch.get("prefix_embeds"))
    return tr.forward(params, cfg, tokens)


def mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pad vocab columns never win: masked to -1e30 (exact for both
    softmax-xent and argmax decode)."""
    if cfg.vocab_pad == 0:
        return logits
    col = last_dim_index(logits)
    return torch.where(col >= cfg.vocab,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device), logits)


def loss(params: Params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    """Mean token cross-entropy (with the z-loss, ``layers.softmax_xent``)
    of ``batch["labels"]``: the padded vocab is masked first; the VLM's
    prefix positions carry no label and are dropped; codebook logits
    (B, S, n_cb, V) take labels (B, S, n_cb)."""
    logits = mask_vocab_pad(forward(params, cfg, batch), cfg)
    if cfg.n_codebooks:
        logits = hint_first(logits, [("data", None, None, "model"),
                                     ("data", "model", None, None)])
    else:
        logits = hint_first(logits, [("data", None, "model"),
                                     ("data", "model", None)])
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    return L.softmax_xent(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """The decode cache: ``{"k", "v"}`` for the attention families,
    ``{"ssm": {"conv", "ssm"}}`` for the SSM family, both for the
    hybrid.  Made on ``device`` (CUDA unless said otherwise)."""
    tr.check_family(cfg)
    if cfg.family not in _RECURRENT:
        return tr.init_cache(cfg, batch, max_len, device=device)
    from ..device import resolve

    dev = resolve(device)
    if cfg.family == "ssm":
        return {"ssm": ssm_mod.init_state(cfg, batch, device=dev)}
    return hy.init_cache(cfg, batch, max_len, device=dev)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    tr.check_family(cfg)
    if cfg.family == "ssm":
        return {"ssm": ssm_mod.state_specs(cfg, batch)}
    if cfg.family == "hybrid":
        return hy.cache_specs(cfg, batch, max_len)
    return tr.cache_specs(cfg, batch, max_len)


def _ssm_decode(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, index: int):
    x = L.embed(params["embed"], tokens)
    conv, state = cache["ssm"]["conv"], cache["ssm"]["ssm"]
    for layer in range(cfg.n_layers):
        slc = {k: v[layer] for k, v in params.items() if k.startswith("m_")}
        x, st = ssm_mod.block_forward(
            slc, x, cfg, state={"conv": conv[layer], "ssm": state[layer]},
            prefix="m_")
        conv[layer] = st["conv"]
        state[layer] = st["ssm"]
    x = L.rms_norm(x, params["final_norm"])
    return project(x, params["lm_head"]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, index: int):
    """One decode step (the attention families also take a block of
    tokens; the recurrent ones one token, (B, 1)).  The cache is
    updated in place; returns ``(logits, cache)``."""
    tr.check_family(cfg)
    if cfg.family == "ssm":
        return _ssm_decode(params, cfg, cache, tokens, index)
    if cfg.family == "hybrid":
        return hy.decode_step(params, cfg, cache, tokens, index)
    return tr.decode_step(params, cfg, cache, tokens, index)
