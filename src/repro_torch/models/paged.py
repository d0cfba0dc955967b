"""Paged KV cache and the decode step over it (the reference's
``models/paged.py`` in PyTorch).

KV lives in fixed-size pages; each request owns a page list (its
``page_table`` row) and a live length (``seq_lens``), and one decode
step is the ``decode_attention`` pipeline DAG: a KV-append producer
feeding an online-softmax fold over a ragged streaming domain
(``core.ir.RaggedExtent``).  Two KV layouts, the DSE axis
``core.dse.select_paged_decode_blocks`` searches:

  * ``split``  -- separate K and V pools, each ``(L, P, ps, Hkv, dh)``;
  * ``fused``  -- one pool ``(L, P, ps, 2*Hkv, dh)`` with K at head
    ``2h`` and V at ``2h+1``.

``paged_decode_step`` mirrors ``model.decode_step`` (the same layer loop,
products and casts; only the cache write and read become page scatter
and gather, both exact permutations), so with a no-wrap dense cache of
the page-padded extent the ``use_kernel=False`` path gives the dense
oracle's tokens.  ``use_kernel=True`` runs the fused kernel
``codegen_cuda.lower_paged_decode`` (append + online softmax in one
launch per layer); serving certifies it against the dense oracle first.

Unlike the reference's functional cache, the pools are updated in
place: each layer's kernel writes its own ``pool[li]`` view, so a step
never restacks the layers' pools.  The bookkeeping methods
(``assign_pages``, ``write_tokens``) also write in place and return the
cache, so the reference's ``cache = cache.assign_pages(...)`` reads the
same.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.dse import PAGED_LAYOUTS
from . import layers as L
from .config import ModelConfig
from .transformer import (Params, _embed_tokens, _ffn, _head, _proj, _qkv,
                          check_family, dtype_of, super_blocks)


class PagedKVCache:
    """Blocked KV storage: ``buffers`` is a tuple of page pools
    (``(k_pages, v_pages)`` for split, ``(kv_pages,)`` for fused),
    ``page_table[b]`` the request's logical -> physical page map,
    ``seq_lens[b]`` its live token count.  Physical page 0 is reserved
    as scratch so inactive slots always have somewhere valid to point.
    """

    def __init__(self, buffers: Tuple[torch.Tensor, ...],
                 page_table: torch.Tensor, seq_lens: torch.Tensor, *,
                 layout: str, page_size: int):
        if layout not in PAGED_LAYOUTS:
            raise ValueError(f"layout {layout!r}; one of {PAGED_LAYOUTS}")
        self.buffers = tuple(buffers)
        self.page_table = page_table
        self.seq_lens = seq_lens
        self.layout = layout
        self.page_size = page_size

    def replace(self, **kw) -> "PagedKVCache":
        args = {"buffers": self.buffers, "page_table": self.page_table,
                "seq_lens": self.seq_lens, "layout": self.layout,
                "page_size": self.page_size}
        args.update(kw)
        return PagedKVCache(args["buffers"], args["page_table"],
                            args["seq_lens"], layout=args["layout"],
                            page_size=args["page_size"])

    # ------------------------------------------------------------ shapes
    @property
    def n_pages(self) -> int:       # physical pool size
        return self.buffers[0].shape[1]

    @property
    def n_pages_max(self) -> int:   # logical pages per request
        return self.page_table.shape[1]

    @property
    def max_context(self) -> int:
        return self.n_pages_max * self.page_size

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, max_len: int, *,
             page_size: int, layout: str = "split", n_pages: int = 0,
             dtype=None, device=None) -> "PagedKVCache":
        """Fresh pool on ``device`` (CUDA unless said otherwise).
        ``page_table`` starts with every request's pages linearly
        pre-assigned (request ``b`` owns pages ``1 + b*n .. 1 +
        (b+1)*n - 1``); continuous batching rewrites rows through
        :meth:`assign_pages` as requests come and go."""
        from ..device import resolve

        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "paged decode has no ring semantics; sliding-window "
                f"config {cfg.name} needs the dense cache")
        if layout not in PAGED_LAYOUTS:
            raise ValueError(f"layout {layout!r}; one of {PAGED_LAYOUTS}")
        dev = resolve(device)
        dt = dtype or dtype_of(cfg)
        nl, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        npm = -(-max_len // page_size)
        pool = max(n_pages, 1 + batch * npm)   # + reserved page 0
        heads = 2 * hkv if layout == "fused" else hkv
        shape = (nl, pool, page_size, heads, dh)
        buffers = tuple(torch.zeros(shape, dtype=dt, device=dev)
                        for _ in range(1 if layout == "fused" else 2))
        table = 1 + torch.arange(batch * npm, dtype=torch.int32,
                                 device=dev).reshape(batch, npm)
        return cls(buffers, table,
                   torch.zeros((batch,), dtype=torch.int32, device=dev),
                   layout=layout, page_size=page_size)

    # ------------------------------------------------- slot bookkeeping
    def assign_pages(self, slot: int, pages: Sequence[int],
                     length: int) -> "PagedKVCache":
        """Point request ``slot`` at ``pages`` (list padded with 0) with
        ``length`` live tokens (continuous-batching admit and evict)."""
        row = torch.zeros((self.n_pages_max,), dtype=torch.int32)
        row[:len(pages)] = torch.as_tensor(list(pages), dtype=torch.int32)
        self.page_table[slot] = row.to(self.page_table.device)
        self.seq_lens[slot] = int(length)
        return self

    def write_tokens(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                     start: int) -> "PagedKVCache":
        """Scatter prefilled K/V (``(L, Hkv, S, dh)``) for request
        ``slot`` at positions ``start..start+S-1`` (the admit path: the
        dense prefill cache lands in this slot's pages)."""
        s = k.shape[2]
        pos = start + torch.arange(s, device=self.page_table.device)
        flat = (self.page_table[slot, pos // self.page_size].long()
                * self.page_size + pos % self.page_size)
        if self.layout == "fused":
            nl, hkv, _, dh = k.shape
            kv = torch.stack([k, v], dim=2)           # (L, Hkv, 2, S, dh)
            kv = kv.reshape(nl, 2 * hkv, s, dh).transpose(1, 2)
            fl = _flat(self.buffers[0])
            fl[:, flat] = kv.to(fl.dtype)
        else:
            for buf, t in zip(self.buffers, (k, v)):
                fl = _flat(buf)
                fl[:, flat] = t.transpose(1, 2).to(fl.dtype)
        return self

    def gather_dense(self, li: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense ``(B, Hkv, Cmax, dh)`` K and V views of layer ``li``
        (logical order; positions past ``seq_lens`` are whatever the
        mapped page holds and must be masked by the caller)."""
        pools = tuple(buf[li] for buf in self.buffers)
        return _gather_layer(pools, self.page_table, self.layout,
                             self.page_size)


def _flat(buf: torch.Tensor) -> torch.Tensor:
    """Pages flattened to one token axis: ``(..., P*ps, H, dh)``, a view
    of ``buf`` (writes land in the pool)."""
    *lead, p, ps, h, dh = buf.shape
    return buf.view(*lead, p * ps, h, dh)


def _append_layer(pools, page_table, seq_lens, k, v, layout: str,
                  page_size: int) -> Tuple[torch.Tensor, ...]:
    """Scatter the token K/V (``(B, Hkv, dh)``) into one layer's pools
    (each ``(P, ps, H, dh)``) at each request's ``seq_lens`` slot, in
    place; returns the pools."""
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    lens = seq_lens.long()
    idx = (page_table[rows, lens // page_size].long() * page_size
           + lens % page_size)
    if layout == "fused":
        b_, hkv, dh = k.shape
        kv = torch.stack([k, v], dim=2).reshape(b_, 2 * hkv, dh)
        fl = _flat(pools[0])
        fl[idx] = kv.to(fl.dtype)
        return tuple(pools)
    for pool, t in zip(pools, (k, v)):
        fl = _flat(pool)
        fl[idx] = t.to(fl.dtype)
    return tuple(pools)


def _gather_layer(pools, page_table, layout: str, page_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(B, Hkv, Cmax, dh)`` K/V copies of one layer's pools."""
    npm = page_table.shape[1]
    pos = torch.arange(npm * page_size, device=page_table.device)
    gidx = (page_table[:, pos // page_size].long() * page_size
            + pos % page_size)                           # (B, Cmax)
    if layout == "fused":
        g = _flat(pools[0])[gidx]                        # (B, Cmax, 2H, dh)
        b_, cmax, h2, dh = g.shape
        g = g.reshape(b_, cmax, h2 // 2, 2, dh)
        ck, cv = g[..., 0, :], g[..., 1, :]
    else:
        ck = _flat(pools[0])[gidx]
        cv = _flat(pools[1])[gidx]
    return ck.transpose(1, 2), cv.transpose(1, 2)


# -------------------------------------------------------------- decode
def _paged_attn(p, x, cfg: ModelConfig, pools, page_table, seq_lens,
                layout: str, page_size: int, use_kernel: bool):
    """One layer's decode attention over its page pools: the products and
    casts of ``transformer._attn``'s decode branch with per-request
    positions.  The pools are updated in place."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None])
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, dh)
    k1, v1 = k[:, 0], v[:, 0]                            # (B, Hkv, dh)

    if use_kernel:
        from ..core.codegen_cuda import lower_paged_decode
        kern = lower_paged_decode(
            batch=b, kv_heads=hkv, group=group, head_dim=dh,
            page_size=page_size, n_pages_max=page_table.shape[1],
            layout=layout)
        out, _ = kern(qg[:, 0], k1, v1, pools, page_table, seq_lens)
        out = out[:, None]                               # (B, 1, Hkv, g, dh)
    else:
        _append_layer(pools, page_table, seq_lens, k1, v1, layout,
                      page_size)
        ck, cv = _gather_layer(pools, page_table, layout, page_size)
        scores = torch.einsum("bskgh,bkch->bskgc", qg.float(),
                              ck.float()) * dh ** -0.5
        slotpos = torch.arange(ck.shape[2], device=x.device)
        valid = slotpos[None, :] <= seq_lens[:, None].long()  # (B, Cmax)
        scores = scores.masked_fill(~valid[:, None, None, None, :],
                                    float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bskgc,bkch->bskgh", probs, cv.float())
    out = out.reshape(b, s, hq * dh).to(x.dtype)
    return _proj(out, p["wo"])


def paged_decode_step(params: Params, cfg: ModelConfig,
                      cache: PagedKVCache, tokens: torch.Tensor, *,
                      use_kernel: bool = False):
    """One decode step for every request: tokens ``(B, 1)``, per-request
    positions from ``cache.seq_lens``.  Returns ``(logits, cache')`` with
    every request's length advanced by one (the pools of ``cache`` are
    written in place and shared by ``cache'``).  Dense and MoE attention
    families (the recurrent ones have no KV cache to page); the layers
    run in the reference's super-block order (``transformer.
    super_blocks``)."""
    check_family(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged decode supports dense/moe, not {cfg.family}")
    x = _embed_tokens(params, cfg, tokens)
    table, lens = cache.page_table, cache.seq_lens
    layout, ps = cache.layout, cache.page_size
    for sl, is_moe in super_blocks(params, cfg, *cache.buffers):
        x = x + _paged_attn(sl, L.rms_norm(x, sl["ln1"]), cfg, sl["extra"],
                            table, lens, layout, ps, use_kernel)
        x = x + _ffn(sl, L.rms_norm(x, sl["ln2"]), cfg, is_moe)
    return _head(params, x), cache.replace(seq_lens=lens + 1)
