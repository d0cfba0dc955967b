"""Decoder-only transformer: the dense GQA, MoE and multimodal
backbones (the reference's ``models/transformer.py`` in PyTorch).

Params are a dict of tensors with a stacked leading layer axis, as in
the reference, and the layer loop walks that axis in the reference's
super-block order (``super_blocks``).  Supports GQA / MQA attention with RoPE, optional QKV
bias (Qwen-2), optional sliding window, and the swiglu, squared-ReLU
and gelu FFNs, MoE FFN layers (every ``moe_layer_period``-th layer,
``models.moe``; Mixtral every layer, Llama-4 every other one with a
shared expert); multi-codebook token embeddings and heads (MusicGen:
embeddings ``(n_cb, V, d)`` summed over the codebooks, heads
``(n_cb, d, V)``, logits ``(B, S, n_cb, V)``) and prefix embeddings from
a stubbed modality frontend (InternVL); full-sequence forward (training
and prefill; ``cfg.remat`` recomputes each super-block in the backward,
``torch.utils.checkpoint``) and single-token (or block) decode with a
preallocated KV cache (sliding-window configs keep a ring buffer of
``min(window, max_len)``).

The decode cache is written in place and returned (the reference's
serving steps donate it).  The recurrent families live in ``models.ssm``
and ``models.hybrid`` (whose shared block reuses ``_attn`` and
``_dense_ffn``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L
from . import moe as moe_mod
from .config import ModelConfig
from .sharding import (hint, hint_first, is_dtensor, model_axis_size,
                       on_local, pinned, project, split_dim)

Params = Dict[str, Any]

# float64 is the port's own oracle type (a float32 train step is held
# against the same step in float64); the reference defines the others
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the reference does not define, or an MoE
    family without experts (and experts outside it)."""
    if cfg.family not in FAMILIES \
            or (cfg.family == "moe") != bool(cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: no {cfg.family} family with "
            f"{cfg.n_experts} experts (families: {', '.join(FAMILIES)})")


# ----------------------------------------------------------------- shapes
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, init_kind); init_kind in {embed, dense, zeros}."""
    check_family(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    nl = cfg.n_layers
    qk, kv = cfg.qk_dim, cfg.kv_dim
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "embed": (ncb + (v, d), "embed"),
        "lm_head": (ncb + (d, v), "dense"),
        "final_norm": ((d,), "zeros"),
        "ln1": ((nl, d), "zeros"),
        "ln2": ((nl, d), "zeros"),
        "wq": ((nl, d, qk), "dense"),
        "wk": ((nl, d, kv), "dense"),
        "wv": ((nl, d, kv), "dense"),
        "wo": ((nl, qk, d), "dense"),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": ((nl, qk), "zeros"),
                       "bk": ((nl, kv), "zeros"),
                       "bv": ((nl, kv), "zeros")})
    n_moe = nl // cfg.moe_layer_period if cfg.n_experts else 0
    n_dense = nl - n_moe
    if n_dense:
        shapes.update({"w1": ((n_dense, d, f), "dense"),
                       "w2": ((n_dense, f, d), "dense")})
        if cfg.activation == "swiglu":
            shapes["w3"] = ((n_dense, d, f), "dense")
    for k_, s_ in moe_mod.param_shapes(cfg, n_moe).items() if n_moe else ():
        shapes[f"moe_{k_}"] = (s_, "dense")
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, drawn in sorted parameter order (other numbers than the
    reference's ``jax.random`` gives; the tests carry the reference's
    weights across with ``convert.params_from_numpy``)."""
    from ..device import resolve

    dev = resolve(device)
    dt = dtype_of(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shape, kind) in sorted(param_shapes(cfg).items()):
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=dev)
        elif kind == "embed":
            out[name] = L.embed_init(gen, shape, dt, dev)
        else:
            in_axis = -2 if len(shape) >= 2 else 0
            out[name] = L.dense_init(gen, shape, in_axis, dt, dev)
    return out


# -------------------------------------------------------------- attention
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dq->bsq")`` in the inputs' type (float32
    accumulation inside the product); on a mesh, ``sharding.project``."""
    return project(x, w)


def _qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """Rotated q (B, S, Hq, dh), rotated k and plain v (B, S, Hkv, dh)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.rope(split_dim(q, -1, hq), positions, cfg.rope_theta)
    k = L.rope(split_dim(k, -1, hkv), positions, cfg.rope_theta)
    return q, k, split_dim(v, -1, hkv)


def _attn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor,
          kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          cache_index: Optional[int] = None):
    """x: (B, S, D).  With kv_cache=(k, v) of (B, Hkv, C, dh), performs
    decode: writes this step's k/v at ``cache_index`` (mod C: ring
    buffer for sliding windows) into the cache, in place, and attends
    over the cache."""
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, positions)
    q = hint(q, "data", None, "model", None)
    k = hint(k, "data", None, "model", None)
    group = hq // hkv

    if kv_cache is None:
        out = _sdpa_chunked(q, k, v, positions, cfg)
        # pinned: the view's backward splits the heads again
        return _proj(pinned(out.reshape(b, s, hq * dh)), p["wo"]), None

    ck, cv = kv_cache                                   # (B, Hkv, C, dh)
    c = ck.shape[2]
    widx = int(cache_index) % c
    # lax.dynamic_update_slice clamps the start so the block fits
    w0 = min(widx, c - s)
    ck[:, :, w0:w0 + s] = k.transpose(1, 2).to(ck.dtype)
    cv[:, :, w0:w0 + s] = v.transpose(1, 2).to(cv.dtype)
    qg = split_dim(q, 2, hkv)                          # (B, S, Hkv, g, dh)
    slotpos = torch.arange(c, device=x.device)
    # ring semantics relative to the LAST slot this block wrote: slot j
    # holds absolute position last - ((wlast - j) mod C); query row i
    # sits at cache_index + i; abspos < 0 marks never-written slots
    last = int(cache_index) + s - 1
    wlast = widx + s - 1
    abspos = last - torch.remainder(wlast - slotpos, c)
    qpos = int(cache_index) + torch.arange(s, device=x.device)
    valid = (abspos[None, :] <= qpos[:, None]) & (abspos >= 0)[None, :]
    if cfg.sliding_window is not None:
        valid &= abspos[None, :] > qpos[:, None] - cfg.sliding_window
    # each (batch row, KV head) attends alone: on a mesh each rank runs
    # its own (``on_local``; the caches, viewed with heads at dim 2, come
    # first and set the layout: the step's queries move, not the cache)
    out = on_local(functools.partial(_attend_cache, valid=valid),
                   (0, 2), ck.transpose(1, 2), cv.transpose(1, 2), qg)
    out = out.reshape(b, s, hq * dh).to(x.dtype)
    return _proj(out, p["wo"]), (ck, cv)


def _attend_cache(ckt: torch.Tensor, cvt: torch.Tensor, qg: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Decode attention over the cache: the caches (B, C, Hkv, dh), qg
    (B, S, Hkv, g, dh), ``valid`` (S, C) -> (B, S, Hkv, g, dh) in
    float32."""
    ck, cv = ckt.transpose(1, 2), cvt.transpose(1, 2)   # (B, Hkv, C, dh)
    scores = torch.einsum("bskgh,bkch->bskgc", qg.float(),
                          ck.float()) * qg.shape[-1] ** -0.5
    scores = scores.masked_fill(~valid[None, :, None, None, :],
                                float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bskgc,bkch->bskgh", probs, cv.float())


ATTN_CHUNK = 1024  # q-block size for the tiled softmax


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tiled softmax attention over query blocks of ``ATTN_CHUNK`` with
    an online softmax over key blocks of the same size: the reference's
    XLA-level flash attention, eagerly.  Masked scores are -1e30; p is
    rounded to V's type before the PV product; float32 statistics
    (float64 for float64 inputs).  Under mesh hints the heads are padded
    with zeros to a multiple of the model axis, as the reference's are
    (Llama-4's 40, MusicGen's 24, InternVL's 14 on a 16-way axis), so
    that attention shards by head; the padded heads are dropped after.

    q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh) -> (B, S, Hq, dh)
    """
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    kq = k.repeat_interleave(group, dim=2)
    vq = v.repeat_interleave(group, dim=2)
    hq_orig = hq
    ms = model_axis_size()
    if ms and hq % ms != 0:
        pad = (-hq) % ms
        zq = torch.zeros((b, s, pad, dh), dtype=q.dtype, device=q.device)
        q, kq, vq = (torch.cat([t, zq], dim=2) for t in (q, kq, vq))
        hq += pad
    head = [("data", None, "model", None)]
    q, kq, vq = (hint_first(t, head) for t in (q, kq, vq))

    # each (batch row, head) attends alone: on a mesh each rank runs the
    # blocks on its own rows and heads (``on_local``)
    out = on_local(functools.partial(_attend_blocks, positions=positions,
                                     cfg=cfg), (0, 2), q, kq, vq)
    return out if hq == hq_orig else out[:, :, :hq_orig]


def _attend_blocks(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                   positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """``_sdpa_chunked``'s blocks: q, kq, vq (B, S, H, dh), one head of
    kq / vq per query head -> (B, S, H, dh)."""
    b, s, hq, dh = q.shape
    bq = min(ATTN_CHUNK, s)
    if s % bq != 0:
        bq = s
    scale = dh ** -0.5
    st = dict(dtype=L.acc_dtype(q), device=q.device)
    outs = []
    for q0 in range(0, s, bq):
        qb = L.up(q[:, q0:q0 + bq])
        pb = positions[q0:q0 + bq]
        m_run = torch.full((b, hq, bq), -1e30, **st)
        l_run = torch.zeros((b, hq, bq), **st)
        acc = torch.zeros((b, hq, bq, dh), **st)
        for k0 in range(0, s, bq):
            kb, vb = kq[:, k0:k0 + bq], vq[:, k0:k0 + bq]
            kp = positions[k0:k0 + bq]
            s_ = torch.einsum("bshd,bthd->bhst", qb, L.up(kb)) * scale
            mask = kp[None, :] <= pb[:, None]
            if cfg.sliding_window is not None:
                mask &= kp[None, :] > pb[:, None] - cfg.sliding_window
            s_ = torch.where(mask[None, None], s_, -1e30)
            m_new = torch.maximum(m_run, s_.amax(-1))
            p = torch.exp(s_ - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", L.up(p.to(vb.dtype)), L.up(vb))
            m_run = m_new
        denom = torch.where(l_run == 0.0, 1.0, l_run)
        out = (acc / denom[..., None]).to(vq.dtype)
        outs.append(out.transpose(1, 2))             # (b, bq, h, dh)
    return torch.cat(outs, dim=1)


def _dense_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = L.activation("silu" if cfg.activation == "swiglu"
                       else cfg.activation)
    h = _proj(x, p["w1"])
    if cfg.activation == "swiglu":
        h = act(h) * _proj(x, p["w3"])
    else:
        h = act(h)
    h = hint(h, "data", None, "model")
    return _proj(h, p["w2"])


def _ffn(slc: Dict, h, cfg: ModelConfig, is_moe: bool):
    """The layer's FFN on the normed residual ``h``: the MoE sublayer on
    the ``moe_*`` slices, else the dense FFN."""
    if is_moe:
        return moe_mod.moe_ffn({k[4:]: v for k, v in slc.items()
                                if k.startswith("moe_")}, h, cfg)
    return _dense_ffn(slc, h, cfg)


def _block(slc: Dict, x, cfg: ModelConfig, positions, is_moe: bool = False,
           kv_cache=None, cache_index=None):
    a, new_cache = _attn(slc, L.rms_norm(x, slc["ln1"]), cfg, positions,
                         kv_cache, cache_index)
    x = x + a
    x = x + _ffn(slc, L.rms_norm(x, slc["ln2"]), cfg, is_moe)
    x = hint(x, "data", "model", None)
    return x, new_cache


_ATTN_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "bq", "bk", "bv")
_DENSE_KEYS = ("w1", "w2", "w3")


def _layer_stacks(params: Params, cfg: ModelConfig):
    """The per-layer stacks: attention (all layers), the dense FFN (dense
    layers) and the MoE FFN (MoE layers)."""
    attn = {k: params[k] for k in _ATTN_KEYS if k in params}
    dense = {k: params[k] for k in _DENSE_KEYS if k in params}
    moe = {k: v for k, v in params.items() if k.startswith("moe_")}
    return attn, dense, moe


def super_blocks(params: Params, cfg: ModelConfig, *stacks):
    """The reference's super-block loop, flattened: for each layer in
    order, ``(slices, is_moe)``.  A super-block is ``period``
    layers, ``period - 1`` dense ones then one MoE layer (period 1, as
    Mixtral's, is MoE only; a dense model has period 1 and no MoE); the
    attention stack and each extra per-layer stack in ``stacks`` (a
    cache or pool axis) are indexed by layer, the dense stacks by dense
    layer and the MoE stacks by MoE layer.  ``slices`` holds the
    layer's attention, FFN and extra slices under their names, the
    extras in order under ``"extra"``."""
    attn, dense, moe = _layer_stacks(params, cfg)
    period = cfg.moe_layer_period if cfg.n_experts else 1
    n_dense_per = period - 1 if moe else period
    for sb in range(cfg.n_layers // period):
        for i in range(period):
            layer = sb * period + i
            is_moe = bool(moe) and i == period - 1
            sl = {k: v[layer] for k, v in attn.items()}
            if is_moe:
                sl.update({k: v[sb] for k, v in moe.items()})
            else:
                sl.update({k: v[sb * n_dense_per + i]
                           for k, v in dense.items()})
            sl["extra"] = tuple(t[layer] for t in stacks)
            yield sl, is_moe


def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, d); multi-codebook tokens (B, S, n_cb)
    sum their codebooks' embeddings in codebook order (the EnCodec
    frame stack), each add in the model's type, as the reference's."""
    if cfg.n_codebooks:
        return sum(L.embed(params["embed"][i], tokens[..., i])
                   for i in range(cfg.n_codebooks))
    return L.embed(params["embed"], tokens)


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits of the normed residual: (B, S, V), or (B, S, n_cb, V)
    for codebook heads (n_cb, d, V)."""
    x = L.rms_norm(x, params["final_norm"])
    head = params["lm_head"]
    if head.dim() == 2:
        return _proj(x, head)
    if is_dtensor(x):   # one product a codebook: no batched-product view
        return torch.stack([_proj(x, head[i]) for i in range(head.shape[0])],
                           dim=2)
    return torch.einsum("bsd,ndv->bsnv", x, head)


def _super_block(x, layers, cfg: ModelConfig, positions):
    for sl, is_moe in layers:
        x, _ = _block(sl, x, cfg, positions, is_moe)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward.  tokens: (B, S[, n_codebooks]) integers;
    prefix_embeds: (B, P, d) from the stubbed modality frontend, put
    ahead of the tokens in the model's type -> logits (B, P + S[, n_cb],
    padded vocab) in the model's type.  With ``cfg.remat`` and autograd
    recording, each super-block (``period`` layers) is recomputed in the
    backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` saves nothing inside one)."""
    check_family(cfg)
    x = _embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = hint(x, "data", None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    period = cfg.moe_layer_period if cfg.n_experts else 1
    layers = list(super_blocks(params, cfg))
    for i in range(0, len(layers), period):
        x = L.remat(cfg, _super_block, x, layers[i:i + period], cfg,
                    positions)
    return _head(params, x)


# ------------------------------------------------------------------ decode
def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def _cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    check_family(cfg)
    return (cfg.n_layers, batch, cfg.n_kv_heads, cache_len(cfg, max_len),
            cfg.head_dim)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    from ..device import resolve

    dev = resolve(device)
    dt = dtype or dtype_of(cfg)
    shp = _cache_shape(cfg, batch, max_len)
    return {"k": torch.zeros(shp, dtype=dt, device=dev),
            "v": torch.zeros(shp, dtype=dt, device=dev)}


def cache_specs(cfg: ModelConfig, batch: int,
                max_len: int) -> Dict[str, torch.Tensor]:
    """The cache's shapes and types as tensors on the ``meta`` device
    (no memory)."""
    shp = _cache_shape(cfg, batch, max_len)
    return {n: torch.empty(shp, dtype=dtype_of(cfg), device="meta")
            for n in ("k", "v")}


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, index: int):
    """One decode step.  tokens: (B, S[, n_codebooks]); index: the current position
    (number of tokens already in the cache).  ``S > 1`` is block decode
    (the whole-prompt prefill): the S tokens are written to the cache
    contiguously at ``index`` and attend causally among themselves and
    over the cache; the block must not wrap the ring buffer.  The cache
    is updated in place; returns ``(logits, cache)``."""
    check_family(cfg)
    x = _embed_tokens(params, cfg, tokens)
    index = int(index)
    positions = index + torch.arange(x.shape[1], device=x.device)
    for sl, is_moe in super_blocks(params, cfg, cache["k"], cache["v"]):
        x, _ = _block(sl, x, cfg, positions, is_moe,
                      kv_cache=sl["extra"], cache_index=index)
    return _head(params, x), cache
