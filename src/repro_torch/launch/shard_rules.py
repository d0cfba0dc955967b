"""Sharding rules: params, optimizer state, activations, caches (the
reference's ``launch/shard_rules.py`` on ``torch.distributed``).

Single source of truth for how every tensor maps onto the production
mesh.  Divisibility is always checked -- dims that do not divide the
mesh axis (granite's 49155 vocab, internvl's 14 heads) fall back to
replication for that dim.

Param rules (Megatron pairing -- one all-reduce per sublayer):
  wq/wk/wv : shard output columns over "model"
  wo       : shard input rows over "model"
  w1/w3    : columns over "model";  w2: rows over "model"
  experts  : expert dim over "model" when divisible (EP), else the
             ffn dim (TP inside experts -- Mixtral's 8 experts on a
             16-way axis)
  embed/lm_head: vocab dim over "model"
ZeRO-1: optimizer m/v/ef additionally shard their largest replicated
dim over ("pod","data") when divisible; ZeRO-3 (``cfg.fsdp``) does the
same for the parameters.

The rules are arithmetic on the mesh's axis names and sizes: ``mesh``
is a ``DeviceMesh`` with dim names or a mapping of name to size.  Each
result is a ``Sharding``: the spec as the reference's tuple (right-
aligned, one entry per dim), its DTensor ``placements`` and
``shard_shape``.  The rules shard only dims that divide, so no shard is
uneven (``batch_sharding`` shards the batch dim unchecked, as the
reference's does; ``shard_shape`` raises where that does not divide).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from ..models.config import ModelConfig
from ..models.sharding import (Spec, axes_size, axis_names, mesh_axes,
                               placements as _placements)
from ..optim.adamw import AdamWState

# param-name suffix -> spec template (dims right-aligned onto the shape;
# leading stacked layer dims are None)
_RULES = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wo": ("model", None),
    "w1": (None, "model"), "w3": (None, "model"), "w2": ("model", None),
    # moe: expert dim first (EP)
    "moe_we1": ("model", None, None), "moe_we3": ("model", None, None),
    "moe_we2": ("model", None, None),
    "moe_router": (None, "model"),
    "moe_ws1": (None, "model"), "moe_ws3": (None, "model"),
    "moe_ws2": ("model", None),
    # ssm blocks
    "m_in_proj": (None, "model"), "m_out_proj": ("model", None),
    "m_conv_w": (None, "model"),
    # shared attention block (zamba)
    "s_wq": (None, "model"), "s_wk": (None, "model"),
    "s_wv": (None, "model"), "s_wo": ("model", None),
    "s_w1": (None, "model"), "s_w3": (None, "model"),
    "s_w2": ("model", None),
}

_MOE_EP_FALLBACK = {  # experts don't divide: TP inside experts instead
    "moe_we1": (None, None, "model"), "moe_we3": (None, None, "model"),
    "moe_we2": (None, "model", None),
}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's place on ``mesh``: the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return _placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The local shard's shape; raises where a sharded dim does not
        divide (as ``NamedSharding.shard_shape``)."""
        axes = mesh_axes(self.mesh)
        out = []
        for d, dim in enumerate(shape):
            ax = self.spec[d] if d < len(self.spec) else None
            size = axes_size(ax, axes)
            if dim % size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"{ax} ({size})")
            out.append(dim // size)
        return tuple(out)


def _fit(spec: Tuple, shape: Tuple[int, ...], mesh) -> Spec:
    """Right-align the rule onto the shape, pad leading None, and drop
    axes that do not divide."""
    axes = mesh_axes(mesh)
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    return tuple(ax if ax is None or dim % axes_size(ax, axes) == 0
                 else None for dim, ax in zip(shape, full))


def _data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _free(parts, mesh) -> Tuple[str, ...]:
    """The data axes no entry of ``parts`` uses yet."""
    used = {a for ax in parts for a in axis_names(ax)}
    return tuple(a for a in _data_axes(mesh) if a not in used)


def param_sharding(cfg: ModelConfig, mesh,
                   param_specs: Dict[str, Any]) -> Dict[str, Sharding]:
    """name -> ``Sharding`` of each parameter (``param_specs``: anything
    with a ``.shape``, e.g. ``model.param_specs(cfg)``)."""
    out = {}
    axes = mesh_axes(mesh)
    for name, spec in param_specs.items():
        shape = tuple(spec.shape)
        rule = next((r for suffix, r in _RULES.items()
                     if name == suffix or name.endswith(suffix)), None)
        if rule is None:
            out[name] = Sharding(mesh, ())
            continue
        if name in _MOE_EP_FALLBACK and shape[-3] % axes["model"] != 0:
            rule = _MOE_EP_FALLBACK[name]
        pspec = _fit(rule, shape, mesh)
        if cfg.fsdp and len(shape) >= 2:
            # ZeRO-3: also shard a still-replicated divisible dim over
            # data(+pod).  Prefer a WEIGHT dim over the stacked layer
            # dim (dim 0 of >=3-D params)
            parts = list(pspec) + [None] * (len(shape) - len(pspec))
            free = _free(parts, mesh)
            if free:
                fsize = axes_size(free, axes)
                order = list(range(len(shape)))
                if len(shape) >= 3:
                    order = order[1:] + [0]  # weight dims first
                for di in order:
                    if parts[di] is None and shape[di] % fsize == 0:
                        parts[di] = free if len(free) > 1 else free[0]
                        break
            pspec = tuple(parts)
        out[name] = Sharding(mesh, pspec)
    return out


def opt_state_sharding(cfg: ModelConfig, mesh, param_specs,
                       opt_specs: AdamWState) -> AdamWState:
    """ZeRO-1: m/v/ef shard like their param, plus the first still-
    replicated dim shards over the data(+pod) axes when divisible."""
    psh = param_sharding(cfg, mesh, param_specs)
    axes = mesh_axes(mesh)

    def zero1(name, spec):
        shape = tuple(spec.shape)
        base = psh[name].spec
        parts = list(base) + [None] * (len(shape) - len(base))
        free = _free(parts, mesh)
        if free:
            fsize = axes_size(free, axes)
            for d, (dim, ax) in enumerate(zip(shape, parts)):
                if ax is None and dim % fsize == 0:
                    parts[d] = free if len(free) > 1 else free[0]
                    break
        return Sharding(mesh, tuple(parts))

    def map_tree(tree):
        return {k: zero1(k, v) for k, v in tree.items()}

    return AdamWState(
        step=Sharding(mesh, ()),
        m=map_tree(opt_specs.m), v=map_tree(opt_specs.v),
        ef=None if opt_specs.ef is None else map_tree(opt_specs.ef))


def batch_sharding(mesh, specs: Dict[str, Any]) -> Dict[str, Sharding]:
    """The batch dim (dim 0, where larger than 1) over data(+pod)."""
    dax = _data_axes(mesh)
    ax = dax if len(dax) > 1 else dax[0]
    out = {}
    for name, spec in specs.items():
        parts = [None] * len(spec.shape)
        if len(spec.shape) and spec.shape[0] > 1:
            parts[0] = ax
        out[name] = Sharding(mesh, tuple(parts))
    return out


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts (a cache's layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_sharding(cfg: ModelConfig, mesh, cache_specs) -> Any:
    """KV/SSM caches: batch over data(+pod), heads over model."""
    axes = mesh_axes(mesh)
    dax = _data_axes(mesh)
    dsize = axes_size(dax, axes)
    n_model = axes["model"]
    ax = dax if len(dax) > 1 else dax[0]

    def one(spec):
        # layouts: (L, B, H, C, dh) or (L, B, K, C) or (L, B, H, N, dh)
        shape = tuple(spec.shape)
        parts = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dsize == 0:
            parts[1] = ax
        if len(shape) >= 3 and shape[2] % n_model == 0:
            parts[2] = "model"
        return Sharding(mesh, tuple(parts))

    return tree_map(one, cache_specs)
