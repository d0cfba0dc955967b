"""Activation-sharding hints, decoupled from model code (the reference's
``models/sharding.py`` on ``torch.distributed`` DTensors).

Models call ``hint(x, "data", None, "model", None)`` as the reference's
do; by default this is the identity.  ``use_mesh_hints(mesh)`` installs
the reference's mesh-aware constraint: each named axis of the spec is
kept where the tensor's dim divides the axis' size and dropped where it
does not (InternVL's 14 heads on a 16-way model axis), and a DTensor is
redistributed to those placements (``DTensor.redistribute``, what
``jax.lax.with_sharding_constraint`` asks of GSPMD).  A plain tensor,
and any tensor outside the context, passes through unchanged.

A spec is the reference's tuple: one entry per leading tensor dim,
``None``, a mesh axis name, or a tuple of names (``("pod", "data")``,
major first).  ``placements`` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` on every mesh dim that names tensor dim ``d``,
``Replicate()`` elsewhere.  A mesh is a ``DeviceMesh`` with dim names,
or, for the arithmetic alone, a mapping of axis name to size.

The context also enters DTensor's ``implicit_replication``: model code
makes plain tensors from scratch (the rope tables, a causal conv's zero
pad, the attention's running statistics), which then join DTensor
operations as replicated.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

# the mesh of the innermost ``use_mesh_hints``, or None
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh_hints",
                                                       default=None)

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh for sharding rules needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def axis_names(ax) -> Tuple[str, ...]:
    """A spec entry's axis names: () for None."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def axes_size(ax, axes: Mapping[str, int]) -> int:
    return math.prod(axes[a] for a in axis_names(ax))


def fixed_spec(shape: Sequence[int], spec: Spec,
               axes: Mapping[str, int]) -> Spec:
    """The reference's hint ``fn``: each entry kept where its dim exists
    and divides the axes' size, else None."""
    return tuple(ax if ax is not None and d < len(shape)
                 and shape[d] % axes_size(ax, axes) == 0 else None
                 for d, ax in enumerate(spec))


def spec_fits(shape: Sequence[int], spec: Spec,
              axes: Mapping[str, int]) -> bool:
    """The reference's ``check``: every named entry's dim exists and
    divides its axes' size."""
    return all(ax is None or (d < len(shape)
                              and shape[d] % axes_size(ax, axes) == 0)
               for d, ax in enumerate(spec))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the rest.
    A tuple entry must name its axes in the mesh's order (JAX's order:
    the first name is the major one, as DTensor shards mesh dims left to
    right); an axis may be named once."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        got = axis_names(ax)
        idx = [names.index(a) for a in got]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} is not in the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} named twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def hint(x, *spec):
    """Redistribute a DTensor ``x`` to ``spec``'s divisibility-checked
    placements on the ambient mesh; anything else unchanged.  As a
    sharding constraint binds the gradient too, the redistribution is
    made even where ``x`` is already so placed: its backward brings the
    gradient to the same placements."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    fixed = fixed_spec(x.shape, spec, mesh_axes(mesh))
    return x.redistribute(mesh, placements(fixed, mesh))


def _gathered(x, drop):
    """DTensor ``x`` with each mesh dim's placement for which
    ``drop(mesh dim, placement)`` holds made ``Replicate`` (gathered or
    reduced); ``x`` itself where nothing changes or ``x`` is plain."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if drop(i, p) else p
                 for i, p in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _shards(p, dim: int) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(p, Shard) and p.dim == dim


def unsharded(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered where a DTensor has it
    sharded (decode's logits before ``argmax``, whose DTensor rule
    fails over a sharded vocab at batch 1)."""
    dim %= x.ndim
    return _gathered(x, lambda i, p: _shards(p, dim))


def data_gathered(w):
    """A weight with its shards over the data axes ("pod", "data")
    gathered, its "model" shards kept: a ZeRO-3 weight all-gathered
    where it is used, as FSDP does.  (An expert stack sharded over both
    "model" and "data" fails DTensor's batched-product view.)"""
    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names
    return _gathered(w, lambda i, p: names[i] in ("pod", "data"))


def pinned(x):
    """``x`` unchanged, its gradient brought to ``x``'s own placements in
    the backward (a DTensor's identity redistribution): before a view
    whose backward splits a dim, which an unevenly placed gradient
    cannot pass."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def first_spec(x, specs: Sequence[Spec]) -> Optional[Spec]:
    """The first spec whose sharded dims all divide the ambient mesh's
    axes (the reference's ``hint_first`` choice), None outside
    ``use_mesh_hints`` or when none fits."""
    mesh = _MESH.get()
    if mesh is None:
        return None
    axes = mesh_axes(mesh)
    return next((s for s in specs if spec_fits(x.shape, s, axes)), None)


def hint_first(x, specs: Sequence[Spec]):
    """Apply the first spec whose sharded dims all divide the mesh axes
    (vocab-sharded logits, else sequence-sharded where the vocab does
    not divide: granite's 49155)."""
    spec = first_spec(x, specs)
    return x if spec is None else hint(x, *spec)


def split_dim(x, dim: int, heads: int):
    """``x`` with dim ``dim`` (heads x dh) viewed as (heads, dh).  A
    DTensor whose ``dim`` is sharded over mesh dims that do not divide
    ``heads`` is first gathered on those dims: the view cannot split
    heads unevenly (granite's 8 KV heads, or 64 query heads grouped by 8
    KV heads, on a 16-way model axis), and the hint after it would drop
    that axis anyway."""
    dim %= x.ndim
    if is_dtensor(x):
        on = [i for i, p in enumerate(x.placements) if _shards(p, dim)]
        if heads % math.prod(x.device_mesh.shape[i] for i in on):
            x = _gathered(x, lambda i, p: i in on)
    shape = tuple(x.shape)
    return x.reshape(shape[:dim] + (heads, shape[dim] // heads)
                     + shape[dim + 1:])


def proj_input(x):
    """``x`` (B, S, ...) laid out for a projection: where a DTensor has
    its sequence dim sharded (the sequence-parallel residual, the
    reference's ``hint(x, "data", "model", None)``) it is gathered, and
    a pending sum (a row-parallel product's output, not yet reduced) is
    reduced.  Otherwise the product would flatten two sharded dims, or
    carry the sum through, and DTensor would gather the weight instead:
    Megatron's one all-gather or all-reduce a sublayer, as GSPMD
    places it."""
    return _gathered(x, lambda i, p: p.is_partial() or _shards(p, 1))


def project(x, w):
    """``x @ w``, x (..., d) and w (d, q).  On a mesh the input is laid
    out by ``proj_input``, the product is taken on the rows flattened
    here, and the output's gradient is pinned to the output's
    placements: DTensor refuses a view that flattens a sharded sequence
    dim, and the gradient of a product's output can come back so
    sharded (the sequence-parallel residual's)."""
    if not is_dtensor(x):
        return x @ w
    x = proj_input(x)
    lead = tuple(x.shape[:-1])
    out = x.reshape(-1, x.shape[-1]) @ w
    return pinned(out.reshape(lead + (w.shape[-1],)))


def vocab_parallel_embed(table, tokens):
    """``table[tokens]`` for a DTensor ``table`` (V, d), Megatron's
    vocab-parallel embedding: the table's shards over the data axes are
    gathered (a ZeRO-3 table), each rank looks its local tokens up in
    its own vocab rows, zeroing the tokens outside them, and the rows
    are summed over the mesh dims that shard the vocab.
    DTensor's own rules for indexing (its backward, ``index_put``) and
    for ``F.embedding`` (its masked partial sums) fail in some PyTorch
    releases; this runs plain indexing on local tensors.  With the vocab
    unsharded it is a local lookup, bit for bit ``table[tokens]``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    table = data_gathered(table)
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in tokens.placements) if is_dtensor(tokens) else \
        (Replicate(),) * mesh.ndim
    if any(i in vocab for i, p in enumerate(rows) if p != Replicate()):
        raise ValueError("a mesh dim shards both the vocab and the batch")
    local_tokens = (tokens.redistribute(mesh, rows).to_local()
                    if is_dtensor(tokens) else tokens)
    # each rank's rows of the table's gradient come from its own tokens
    # alone: a pending sum over the mesh dims that shard the batch
    local = table.to_local(grad_placements=tuple(
        Partial() if r != Replicate() else p
        for r, p in zip(rows, table.placements)))
    if vocab:
        _, (lo, _) = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        hi = lo + local.shape[0]
        inside = (local_tokens >= lo) & (local_tokens < hi)
        picked = local[(local_tokens - lo).clamp(0, local.shape[0] - 1)]
        picked = picked * inside[..., None].to(picked.dtype)
    else:
        picked = local[local_tokens]
    d_place = {i: Shard(picked.ndim - 1) for i, p in
               enumerate(table.placements) if isinstance(p, Shard)
               and p.dim == 1}
    out = tuple(Partial() if i in vocab else d_place.get(i, rows[i])
                for i in range(mesh.ndim))
    # the pending sum reduced at once, as Megatron's all-reduce after
    # the lookup: no partial activation enters the blocks
    return DTensor.from_local(picked, mesh, out, run_check=False) \
        .redistribute(mesh, tuple(Replicate() if i in vocab else out[i]
                                  for i in range(mesh.ndim)))


def last_dim_index(x):
    """``torch.arange(x.shape[-1])`` laid out as ``x``'s last dim: for a
    DTensor sharded on that dim, each rank holds its own columns (a
    comparison with it then stays on the shards, where a replicated
    index would have DTensor gather ``x``)."""
    col = torch.arange(x.shape[-1], device=x.device)
    if not is_dtensor(x):
        return col
    from torch.distributed.tensor import Replicate, Shard

    last = x.ndim - 1
    mesh = x.device_mesh
    want = tuple(Shard(0) if isinstance(p, Shard) and p.dim == last
                 else Replicate() for p in x.placements)
    rep = DTensor.from_local(col, mesh, (Replicate(),) * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, want)


def on_local(fn, dims, *xs, out_dims=None):
    """``fn(*xs)`` with every DTensor among ``xs`` taken as its local
    shard.  ``dims`` names the tensor dims the work is independent along
    (batch rows, heads, routing groups): one tuple for every input, or a
    tuple an input, aligned, ``None`` where an input lacks that axis.
    The first DTensor's placements on those dims set the layout: each
    input is redistributed to it (sharded on those axes as the first
    one is, replicated on every other dim), ``fn`` runs on the local
    tensors, and each tensor it returns comes back as a DTensor of that
    layout on ``out_dims`` (by default the first DTensor's ``dims``);
    an output must carry every axis the layout shards, and an input
    without one gives back its gradient as a pending sum over it.  For
    work DTensor has no rule for (MoE routing: sorts, ranks, scatters
    per group) or whose products would flatten two sharded dims into
    one (attention per batch row and head, the SSD per batch row and
    head).  Plain tensors: ``fn(*xs)``."""
    first = next((i for i, x in enumerate(xs) if is_dtensor(x)), None)
    if first is None:
        return fn(*xs)
    from torch.distributed.tensor import Partial, Replicate, Shard

    per = list(dims) if dims and isinstance(dims[0], (tuple, list)) \
        else [tuple(dims)] * len(xs)
    lead = xs[first]
    mesh = lead.device_mesh
    # the axis (index into dims) each mesh dim shards, or None
    axis = [per[first].index(p.dim) if isinstance(p, Shard)
            and p.dim in per[first] else None for p in lead.placements]

    def layout(ds):
        return tuple(Shard(ds[k]) if k is not None and ds[k] is not None
                     else Replicate() for k in axis)

    def grads(ds):
        # an input without a sharded axis (B and C beside the SSD's
        # heads) gets from each rank the gradient of its part alone: a
        # pending sum over the mesh dims that shard that axis
        return tuple(Partial() if k is not None and ds[k] is None else p
                     for k, p in zip(axis, layout(ds)))

    local = [x.redistribute(mesh, layout(d)).to_local(
        grad_placements=grads(d)) if is_dtensor(x) else x
        for x, d in zip(xs, per)]
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    want = out_dims or [per[first]] * len(outs)
    wrapped = tuple(DTensor.from_local(t, mesh, layout(d), run_check=False)
                    for t, d in zip(outs, want))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def model_axis_size() -> Optional[int]:
    """Size of the ambient "model" axis (None outside use_mesh_hints)."""
    mesh = _MESH.get()
    return None if mesh is None else int(mesh_axes(mesh)["model"])


@contextlib.contextmanager
def use_mesh_hints(mesh):
    """Install divisibility-checked sharding constraints for ``mesh``
    (a ``DeviceMesh``; a name -> size mapping gives the choices of
    ``first_spec`` and ``model_axis_size`` alone), inside DTensor's
    ``implicit_replication``."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _MESH.reset(token)
