"""Execution semantics for the PPL IR: the eager oracle in PyTorch.

Every transformation must preserve the value computed here, and every
kernel is held against it.  It interprets the same IR as the JAX
reference's ``codegen_jax``: a Map's domain runs as one batched call of
its body (the indices of the domain become a leading batch dimension
where ``vmap`` mapped them), and folds run as plain loops (where
``fori_loop`` ran).  Windows are read with ``dynamic_slice`` semantics:
starts are clamped so the window fits.

Index-map convention (see ir.py): every ``Access.index_map``,
``TileCopy.index_map`` and ``out_index_map`` receives the concatenated
index stack of all *enclosing* pattern domains, outermost first, ending
with the indices of the pattern that owns it.  Body ``fn``s receive the
same stack as their first argument; inside a batched Map the Map's own
entries are index tensors of the batch.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import ir
from ..device import resolve


def _key(src: ir.Source):
    """Binding key: TileCopies use their rewrite-stable uid."""
    return src.uid if isinstance(src, ir.TileCopy) else id(src)


def _unflatten(flat_idx, domain):
    """Flat loop index (int or index tensor) -> multi-index (row-major)."""
    idxs = []
    rem = flat_idx
    for extent in reversed(domain):
        idxs.append(rem % extent)
        rem = rem // extent
    return tuple(reversed(idxs))


def _batch(stack: Tuple) -> Optional[int]:
    """Batch size of a stack holding index tensors, None if all ints."""
    for s in stack:
        if isinstance(s, torch.Tensor) and s.dim() == 1:
            return int(s.shape[0])
    return None


def _as_start(s):
    if isinstance(s, torch.Tensor) and s.dim() == 0:
        return int(s)
    return s if isinstance(s, torch.Tensor) else int(s)


def _slice(arr: torch.Tensor, starts, window: Tuple[int, ...]):
    """``arr[starts : starts + window]``, starts clamped so the window
    fits.  A start that is an index tensor of the batch gathers one
    window per batch entry: the result then has a leading batch dim."""
    lead = arr.dim() - len(window)
    shape = arr.shape[lead:]
    starts = [_as_start(s) for s in starts][-len(window):] if window else []
    clamped = []
    for s, w, e in zip(starts, window, shape):
        if isinstance(s, torch.Tensor):
            clamped.append(s.clamp(0, e - w))
        else:
            clamped.append(min(max(s, 0), e - w))
    if not any(isinstance(s, torch.Tensor) for s in clamped):
        return arr[(Ellipsis,) + tuple(slice(s, s + w)
                                       for s, w in zip(clamped, window))]
    nd = len(window)
    idx = []
    for d, (s, w) in enumerate(zip(clamped, window)):
        r = torch.arange(w, device=arr.device)
        t = (s.reshape(-1, 1) + r) if isinstance(s, torch.Tensor) \
            else (s + r).reshape(1, w)
        view = [t.shape[0]] + [1] * nd
        view[1 + d] = w
        idx.append(t.reshape(view))
    return arr[tuple(idx)]


def _squeeze(win: torch.Tensor, window: Tuple[int, ...],
             batch: Optional[int]) -> torch.Tensor:
    """Windows with singleton dims are squeezed; all-singleton -> scalar
    (behind the batch dimension, which is never squeezed)."""
    kept = tuple(w for w in window if w != 1)
    if batch is not None and win.dim() == len(window) + 1:
        return win.reshape((win.shape[0],) + kept)
    return win.reshape(kept)


def as_inputs(inputs: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """Inputs (numpy arrays or tensors) as tensors on ``device``."""
    dev = resolve(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in inputs.items()}


class Env:
    """Maps symbolic sources to concrete tensors during evaluation."""

    def __init__(self, inputs: Dict[str, torch.Tensor], device):
        self.inputs = inputs
        self.device = device
        self.bindings: Dict[Any, torch.Tensor] = {}

    def child(self) -> "Env":
        sub = Env(self.inputs, self.device)
        sub.bindings = dict(self.bindings)
        return sub

    def resolve(self, src: ir.Source, idx_stack: Tuple) -> torch.Tensor:
        if isinstance(src, ir.Tensor):
            if src.name not in self.inputs:
                raise KeyError(f"input tensor '{src.name}' not provided")
            return self.inputs[src.name]
        if _key(src) in self.bindings:
            return self.bindings[_key(src)]
        if isinstance(src, ir.Pattern):
            if _batch(idx_stack) is not None:
                raise NotImplementedError(
                    "pattern source read inside a batched Map")
            val = _execute(src, self, idx_stack)
            self.bindings[id(src)] = val
            return val
        if isinstance(src, ir.TileCopy):
            # lazy load: AffineMap index maps know their input arity
            from .affine import AffineMap
            if isinstance(src.index_map, AffineMap):
                stack = idx_stack[:src.index_map.n_in]
                val = self._tile(src, stack)
                self.bindings[src.uid] = val
                return val
        raise KeyError(f"unbound source {src!r}")

    def _tile(self, tc: ir.TileCopy, stack: Tuple) -> torch.Tensor:
        if _batch(stack) is not None:
            raise NotImplementedError("tile copy indexed by a batched Map")
        arr = self.resolve(tc.src, stack)
        return _slice(arr, tc.index_map(*stack), tuple(tc.tile_shape))

    def bind(self, src: ir.Source, value: torch.Tensor) -> None:
        self.bindings[_key(src)] = value


def _read_window(env: Env, access: ir.Access, idx_stack: Tuple):
    arr = env.resolve(access.src, idx_stack)
    win = _slice(arr, access.index_map(*idx_stack), tuple(access.window))
    return _squeeze(win, tuple(access.window), _batch(idx_stack))


def _load_tiles(env: Env, p: ir.Pattern, idx_stack: Tuple) -> None:
    # tensor tile-loads first, then pattern-valued stages (which may read
    # the freshly loaded tiles) -- the metapipeline stage order
    loads = sorted(p.loads, key=lambda t: isinstance(t.src, ir.Pattern))
    for tc in loads:
        env.bind(tc, env._tile(tc, idx_stack))


def _windows(env: Env, p: ir.Pattern, idx_stack: Tuple):
    return [_read_window(env, a, idx_stack) for a in p.accesses]


def _value(val, device, dtype=None) -> torch.Tensor:
    out = torch.as_tensor(val, device=device)
    return out if dtype is None else out.to(dtype)


# --------------------------------------------------------------------------
# Per-pattern evaluators.  Each returns the pattern's realized value:
#   Map          -> tensor of shape domain + elem_shape
#   MultiFold    -> tensor of range_shape
#   FlatMap      -> (buffer (trip_count * max_per_iter,)+elem_shape, count)
#   GroupByFold  -> dense (num_keys,)+elem_shape accumulator
# Inside a batched Map a value carries the batch as its leading dim.
# --------------------------------------------------------------------------


def _execute_map(p: ir.Map, env: Env, outer_idx: Tuple) -> torch.Tensor:
    if _batch(outer_idx) is not None:
        raise NotImplementedError("a Map nested in a batched Map")
    n = p.trip_count
    idx = _unflatten(torch.arange(n, device=env.device), p.domain)
    stack = tuple(outer_idx) + idx
    sub = env.child()
    _load_tiles(sub, p, stack)
    if p.inner is not None:
        if isinstance(p.inner, ir.FlatMap):
            raise TypeError("FlatMap cannot nest inside Map (dynamic size)")
        val = _execute(p.inner, sub, stack)
    else:
        val = p.fn(stack, *_windows(sub, p, stack))
    val = _value(val, env.device)
    if val.dim() == 0 or val.shape[0] != n:   # body ignored the batch
        val = val.expand((n,) + tuple(val.shape))
    return val.reshape(tuple(p.domain) + tuple(val.shape[1:]))


def _execute_multifold(p: ir.MultiFold, env: Env,
                       outer_idx: Tuple) -> torch.Tensor:
    acc0 = _value(p.init(), env.device)
    assert tuple(acc0.shape) == tuple(p.range_shape), (
        f"init shape {tuple(acc0.shape)} != range {p.range_shape}")
    batch = _batch(outer_idx)
    lead = () if batch is None else (batch,)
    acc = acc0.expand(lead + tuple(acc0.shape)).clone()
    upd_shape = tuple(p.update_shape)

    for flat_i in range(p.trip_count):
        stack = tuple(outer_idx) + _unflatten(flat_i, p.domain)
        sub = env.child()
        _load_tiles(sub, p, stack)
        starts = [_as_start(s) for s in p.out_index_map(*stack)]
        if any(isinstance(s, torch.Tensor) for s in starts):
            raise NotImplementedError(
                "accumulator slice indexed by a batched Map")
        starts = [min(max(s, 0), e - w) for s, w, e
                  in zip(starts, upd_shape, p.range_shape)]
        sl = (Ellipsis,) + tuple(slice(s, s + w)
                                 for s, w in zip(starts, upd_shape))
        acc_slice = acc[sl]
        if p.inner is not None:
            partial = _value(_execute(p.inner, sub, stack), env.device)
            partial = partial.reshape(lead + upd_shape)
            if p.combine is None:  # write-once (tiled Map), paper's "(_)"
                new = partial
            else:
                new = p.combine(acc_slice, partial)
        else:
            new = p.fn(stack, acc_slice, *_windows(sub, p, stack))
        new = _value(new, env.device, acc.dtype)
        acc[sl] = new.expand(lead + upd_shape) if new.dim() == 0 \
            else new.reshape(lead + upd_shape)
    return acc


def _execute_flatmap(p: ir.FlatMap, env: Env,
                     outer_idx: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """The values each index keeps (its lanes below its count), written in
    index and lane order from the start of a zeroed ``(trip_count *
    max_per_iter,) + elem_shape`` buffer, and the total as a 0-d int32
    tensor.  An untiled FlatMap runs its body once, batched over the
    domain; a tiled one runs its inner FlatMap per grid step.  Each kept
    value then lands at the exclusive prefix sum of the counts before its
    index, which is where the reference's running count writes it."""
    if _batch(outer_idx) is not None:
        raise NotImplementedError("a FlatMap nested in a batched Map")
    n, elem, dev = p.trip_count, tuple(p.elem_shape), env.device
    dtype = getattr(torch, p.dtype)
    cap = n * p.max_per_iter
    if p.inner is None:
        stack = tuple(outer_idx) + _unflatten(torch.arange(n, device=dev),
                                              p.domain)
        sub = env.child()
        _load_tiles(sub, p, stack)
        vals, cnt = p.fn(stack, *_windows(sub, p, stack))
        vals = _value(vals, dev, dtype)
        lanes = p.max_per_iter
        vals = vals.reshape((n, lanes) + elem) \
            if vals.numel() == n * lanes * math.prod(elem) \
            else vals.expand((n, lanes) + elem)
        cnt = _value(cnt, dev, torch.int64).expand(n)
    else:
        steps = []
        for flat_i in range(n):
            stack = tuple(outer_idx) + _unflatten(flat_i, p.domain)
            sub = env.child()
            _load_tiles(sub, p, stack)
            buf, c = _execute(p.inner, sub, stack)
            steps.append((_value(buf, dev, dtype).reshape((-1,) + elem),
                          _value(c, dev, torch.int64).reshape(())))
        vals = torch.stack([v for v, _ in steps])
        cnt = torch.stack([c for _, c in steps])
        lanes = vals.shape[1]
    local = torch.arange(lanes, device=dev)
    dest = (torch.cumsum(cnt, 0) - cnt)[:, None] + local
    # dropped lanes, and any past the buffer, go to a spare last slot
    dest = torch.where((local < cnt[:, None]) & (dest < cap), dest, cap)
    out = torch.zeros((cap + 1,) + elem, dtype=dtype, device=dev)
    out[dest.reshape(-1)] = vals.reshape((-1,) + elem)
    return out[:cap], cnt.sum().to(torch.int32)


def _execute_groupbyfold(p: ir.GroupByFold, env: Env,
                         outer_idx: Tuple) -> torch.Tensor:
    if _batch(outer_idx) is not None:
        raise NotImplementedError("GroupByFold inside a batched Map")
    acc = _value(p.init(), env.device).clone()
    assert tuple(acc.shape) == (p.num_keys,) + tuple(p.elem_shape)
    for flat_i in range(p.trip_count):
        stack = tuple(outer_idx) + _unflatten(flat_i, p.domain)
        sub = env.child()
        _load_tiles(sub, p, stack)
        if p.inner is not None:
            # tiled form: inner yields a dense partial; combine keywise.
            # Correct because init is the identity of combine (required).
            partial = _value(_execute(p.inner, sub, stack), env.device)
            acc = _value(p.combine(acc, partial), env.device, acc.dtype)
            continue
        key, val = p.fn(stack, *_windows(sub, p, stack))
        # dynamic_slice semantics: the key is clamped into the table
        key = min(max(int(_value(key, env.device, torch.int32)), 0),
                  p.num_keys - 1)
        new = p.combine(acc[key], _value(val, env.device, acc.dtype))
        acc[key] = _value(new, env.device, acc.dtype).reshape(
            tuple(p.elem_shape))
    return acc


def _execute(p: ir.Pattern, env: Env, outer_idx: Tuple) -> Any:
    if isinstance(p, ir.Map):
        return _execute_map(p, env, outer_idx)
    if isinstance(p, ir.MultiFold):
        return _execute_multifold(p, env, outer_idx)
    if isinstance(p, ir.FlatMap):
        return _execute_flatmap(p, env, outer_idx)
    if isinstance(p, ir.GroupByFold):
        return _execute_groupbyfold(p, env, outer_idx)
    raise TypeError(f"unknown pattern {type(p)}")


def execute(p: ir.Pattern, inputs: Dict[str, Any], *, device=None) -> Any:
    """Evaluate pattern ``p`` with concrete ``inputs`` (name -> array).
    Runs on CUDA unless ``device`` says otherwise."""
    dev = resolve(device)
    return _execute(p, Env(as_inputs(inputs, dev), dev), ())
