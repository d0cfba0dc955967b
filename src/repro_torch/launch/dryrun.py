"""Multi-pod dry run: every (arch x shape x mesh) cell's step run on
``meta`` shards of a fake production world (the reference's
``launch/dryrun.py`` on ``torch.distributed``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # full sweep

Per cell, inside ``mesh.fake_world(256 or 512)`` (one process, no
device, no peer): the parameters, optimizer state, batch and cache are
DTensors of ``meta`` shards placed by ``launch.shard_rules``, and the
step runs once under ``models.sharding.use_mesh_hints`` --
``steps.make_train_step(..., grad_shardings=)`` (autograd's backward
included) for train, ``make_prefill_step`` for prefill,
``make_serve_step`` for decode -- twice: the first run fills DTensor's
sharding caches (working out a new layout, DTensor runs operations of
its own on global shapes), and over the second a dispatch mode
(``Tally``) watches the plain-tensor operations DTensor runs on the
local shards.
The record keeps the reference's keys:

* ``memory_per_device``: ``argument_bytes``, the bytes of the local
  shards of the step's arguments, exactly; ``output_bytes`` and
  ``alias_bytes``, of what the step returns and of the part of it that
  shares storage with an argument (the parameters, optimizer state and
  cache the step updates in place, which the reference donates);
  ``temp_bytes``, the peak of live bytes of the tensors the step's
  operations make: each new storage counts from the operation that
  makes it until a weakref finalizer on it sees it freed, views and
  in-place results add nothing;
* ``cost_per_device``: ``flops`` of the local operations by
  ``torch.utils.flop_counter``'s formulas; ``bytes_accessed``, the bytes
  of each operation's tensor inputs and outputs (views and collectives
  aside);
* ``collectives``: each functional collective DTensor issues, by its
  result bytes and group size, with the reference's operand and ring-
  wire formulas.  The fake group moves nothing; where a process group
  has no all-to-all (the CPU's), DTensor issues all-gather and chunk
  instead, and that is what is counted;
* the reference's two-point extrapolation, at two and three scan groups
  (``cfg.with_(n_layers=2 g)``, ``3 g``): every count, the temp bytes'
  peak included, extrapolates to the full depth as ``outside + body x
  groups`` (body = c3 - c2, outside = c2 - 2 body), since eager tracing
  costs about a second a layer at granite's widths.  The reference
  starts at one group; here a stacked layer dim of size 1 makes DTensor
  choose other layouts for it (granite-3-2b train_4k on 16x16: 34
  all-reduces at one group, 30 at two, three and four), so counts are
  linear in depth only from two groups.  With at most three groups the
  full depth runs.  ``argument_bytes`` always
  comes from the full depth's specs.  An eager count has no scan body
  counted once, so ``cost_per_device`` and ``cost_per_device_scanned``
  both hold the totals;
* ``lower_s``: seconds of the runs on the meta shards, both of each;
  ``compile_s``: 0, nothing is compiled.

A failing cell gives an ``"error"`` record and exit code 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, SHAPES, get_config, skip_reason
from ..configs.shapes import ShapeConfig
from ..models import model
from ..models.config import ModelConfig
from ..models.sharding import use_mesh_hints
from ..optim import adamw
from . import shard_rules, steps
from .mesh import PRODUCTION, fake_world, make_production_mesh

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kinds() -> Dict[Any, str]:
    """Overload packet -> the reference's collective kind, for every
    functional collective DTensor may issue (those this PyTorch has)."""
    names = {("_c10d_functional", "all_reduce"): "all-reduce",
             ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
             ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
             ("_c10d_functional", "all_gather_into_tensor_coalesced"):
                 "all-gather",
             ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
             ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
                 "reduce-scatter",
             ("_c10d_functional", "all_to_all_single"): "all-to-all",
             ("_c10d_functional_autograd", "all_to_all_single"):
                 "all-to-all",
             ("_c10d_functional_autograd", "reduce_scatter_tensor"):
                 "reduce-scatter",
             ("_c10d_functional_autograd", "all_gather_into_tensor"):
                 "all-gather",
             ("_dtensor", "shard_dim_alltoall"): "all-to-all"}
    kinds = {}
    for (space, op), kind in names.items():
        try:
            kinds[getattr(getattr(torch.ops, space), op)] = kind
        except (AttributeError, RuntimeError):
            continue
    return kinds


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _wire(kind: str, rbytes: int, g: int):
    """(operand bytes, ring wire bytes) of a collective from its result
    bytes and group size (the reference's ``collective_bytes``)."""
    if kind == "all-gather":
        return rbytes // g, (g - 1) / g * rbytes
    if kind == "reduce-scatter":
        return rbytes * g, (g - 1) / g * rbytes * g
    if kind == "all-reduce":
        return rbytes, 2 * (g - 1) / g * rbytes
    if kind == "all-to-all":
        return rbytes, (g - 1) / g * rbytes
    return rbytes, float(rbytes)


class Tally(TorchDispatchMode):
    """Counts the plain-tensor operations under it: their flops
    (``flop_counter``'s formulas), the bytes they read and write, the
    functional collectives (result bytes, group size) and the peak of
    live bytes of the storages they make.  It hands DTensor operations
    back to DTensor (``NotImplemented``), so it sees the local shards'
    operations and the collectives DTensor issues for them, as
    ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.kinds = _collective_kinds()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}
        self.collectives = {k: {"operand_bytes": 0, "result_bytes": 0,
                                "ring_wire_bytes": 0.0, "count": 0}
                            for k in COLLECTIVES}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _made(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._alive:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _collective(self, kind: str, args, outs) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        g = max(1, _resolve_process_group(args[-1]).size())
        rbytes = sum(_nbytes(t) for t in outs)
        obytes, wire = _wire(kind, rbytes, g)
        rec = self.collectives[kind]
        rec["operand_bytes"] += obytes
        rec["result_bytes"] += rbytes
        rec["ring_wire_bytes"] += wire
        rec["count"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs, ins = _tensors(out), _tensors((args, kwargs))
        kind = self.kinds.get(packet)
        if kind is not None:
            self._collective(kind, args, outs)
        elif not getattr(func, "is_view", False):
            if packet in self.flop_registry:
                self.flops += self.flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        self._made(outs, ins)
        return out


def _scan_group(cfg: ModelConfig) -> int:
    """Layers per scan step (extrapolation unit)."""
    if cfg.family == "hybrid":
        return cfg.shared_attn_every
    if cfg.n_experts:
        return cfg.moe_layer_period
    return 1


def _place(spec: torch.Tensor, sh: shard_rules.Sharding, device="meta"):
    """A DTensor of ``spec``'s shape and type placed by ``sh``, its local
    shard a new tensor on ``device`` (``meta``: no memory)."""
    from torch.distributed.tensor import DTensor

    local = torch.zeros(sh.shard_shape(spec.shape), dtype=spec.dtype,
                        device=device)
    return DTensor.from_local(local, sh.mesh, sh.placements,
                              run_check=False, shape=spec.shape,
                              stride=spec.stride())


def _shard_bytes(specs, shardings) -> int:
    """Bytes of the local shards of ``specs`` placed by ``shardings``
    (trees of the same structure)."""
    total = 0
    placed = [sh for sh in tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, shard_rules.Sharding))
        if sh is not None]
    for spec, sh in zip(_tensors(specs), placed, strict=True):
        n = 1
        for d in sh.shard_shape(spec.shape):
            n *= d
        total += n * spec.element_size()
    return total


def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt_compress: bool = False):
    """``(specs, shardings)`` of the step's arguments, in its argument
    order: train (params, opt_state, batch); prefill (params, batch);
    decode (params, cache, tokens, index)."""
    pspecs = model.param_specs(cfg)
    psh = shard_rules.param_sharding(cfg, mesh, pspecs)
    bspecs = steps.input_specs(cfg, shape)
    bsh = shard_rules.batch_sharding(mesh, bspecs)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(compress_grads=opt_compress)
        ospecs = adamw.state_specs(pspecs, opt_cfg)
        osh = shard_rules.opt_state_sharding(cfg, mesh, pspecs, ospecs)
        return (pspecs, ospecs, bspecs), (psh, osh, bsh)
    if shape.kind == "prefill":
        return (pspecs, bspecs), (psh, bsh)
    cspecs, ispec = steps.decode_extras(cfg, shape)
    csh = shard_rules.cache_sharding(cfg, mesh, cspecs)
    scalar = shard_rules.Sharding(mesh, ())
    return ((pspecs, cspecs, bspecs["tokens"], ispec),
            (psh, csh, bsh["tokens"], scalar))


def _run_step(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_compress,
              microbatches: int) -> Dict[str, Any]:
    """Run one configuration's step on meta shards; its raw per-device
    counts."""
    specs, shardings = cell_inputs(cfg, shape, mesh, opt_compress)
    if shape.kind == "train":
        pspecs, ospecs, bspecs = specs
        psh, osh, bsh = shardings
        params = {k: _place(v, psh[k]) for k, v in pspecs.items()}
        state = adamw.AdamWState(
            # the step counter is read on the host (the schedule): a
            # real zero on the mesh's device
            step=_place(ospecs.step, osh.step, device=mesh.device_type),
            m={k: _place(v, osh.m[k]) for k, v in ospecs.m.items()},
            v={k: _place(v, osh.v[k]) for k, v in ospecs.v.items()},
            ef=None if ospecs.ef is None else
            {k: _place(v, osh.ef[k]) for k, v in ospecs.ef.items()})
        batch = {k: _place(v, bsh[k]) for k, v in bspecs.items()}
        fn = steps.make_train_step(
            cfg, adamw.AdamWConfig(compress_grads=opt_compress),
            microbatches=microbatches, grad_shardings=psh)
        args = (params, state, batch)
    elif shape.kind == "prefill":
        pspecs, bspecs = specs
        psh, bsh = shardings
        args = ({k: _place(v, psh[k]) for k, v in pspecs.items()},
                {k: _place(v, bsh[k]) for k, v in bspecs.items()})
        fn = steps.make_prefill_step(cfg)
    else:
        pspecs, cspecs, tspec, _ = specs
        psh, csh, tsh, _ = shardings
        def place_tree(spec_tree, sh_tree):
            if isinstance(spec_tree, dict):
                return {k: place_tree(v, sh_tree[k])
                        for k, v in spec_tree.items()}
            return _place(spec_tree, sh_tree)

        cache = place_tree(cspecs, csh)
        # the position is read on the host: the last slot of the cache
        index = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
        args = ({k: _place(v, psh[k]) for k, v in pspecs.items()}, cache,
                _place(tspec, tsh), index)
        fn = steps.make_serve_step(cfg)
    arg_storages = {t.to_local().untyped_storage()._cdata
                    for t in _tensors(args) if hasattr(t, "to_local")}
    t0 = time.time()
    # the first run fills DTensor's sharding caches: working a new
    # layout out, DTensor runs operations on global shapes of its own,
    # which the count must not see; the second run is counted
    with use_mesh_hints(mesh):
        fn(*args)
    tally = Tally()
    with tally, use_mesh_hints(mesh):
        out = fn(*args)
    secs = time.time() - t0
    locals_ = [t.to_local() if hasattr(t, "to_local") else t
               for t in _tensors(out)]
    out_bytes = sum(_nbytes(t) for t in locals_)
    alias = sum(_nbytes(t) for t in locals_
                if t.untyped_storage()._cdata in arg_storages)
    return {"secs": secs, "flops": float(tally.flops),
            "bytes_accessed": float(tally.bytes_accessed),
            "temp_bytes": tally.peak, "output_bytes": out_bytes,
            "alias_bytes": alias, "collectives": tally.collectives}


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    if shape.kind == "decode":
        return cfg.model_flops(shape.global_batch, training=False)
    return cfg.model_flops(shape.global_batch * shape.seq_len,
                           training=shape.kind == "train")


def _extrap(c2, c3, groups: int):
    """Two-point extrapolation from two and three scan groups to
    ``groups``, numbers kept in their type."""
    body = c3 - c2
    return (c2 - 2 * body) + body * groups


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, mesh,
              opt_compress: bool = False, microbatches: int = 1,
              extrapolate: bool = True) -> Dict[str, Any]:
    """The record's per-device numbers of ``cfg`` x ``shape`` on
    ``mesh`` (a fake world's, or a real one: the shards stay ``meta``)."""
    specs, shardings = cell_inputs(cfg, shape, mesh, opt_compress)
    g = _scan_group(cfg)
    groups = cfg.n_layers // g
    if extrapolate and groups > 3:
        c2 = _run_step(cfg.with_(n_layers=2 * g, unroll=True), shape, mesh,
                       opt_compress, microbatches)
        c3 = _run_step(cfg.with_(n_layers=3 * g, unroll=True), shape, mesh,
                       opt_compress, microbatches)

        def at(key):
            return _extrap(c2[key], c3[key], groups)

        coll = {k: {f: _extrap(c2["collectives"][k][f],
                               c3["collectives"][k][f], groups)
                    for f in c2["collectives"][k]} for k in COLLECTIVES}
        secs = c2["secs"] + c3["secs"]
    else:
        c = _run_step(cfg, shape, mesh, opt_compress, microbatches)

        def at(key):
            return c[key]

        coll = c["collectives"]
        secs = c["secs"]
    coll = dict(coll)
    coll["total_wire_bytes"] = sum(v["ring_wire_bytes"]
                                   for v in coll.values())
    cost = {"flops": float(at("flops")),
            "bytes_accessed": float(at("bytes_accessed"))}
    wire = {k: coll[k]["ring_wire_bytes"] for k in COLLECTIVES}
    wire["total"] = sum(wire.values())
    return {
        "model_flops": _model_flops(cfg, shape),
        "lower_s": round(secs, 2),
        "compile_s": 0.0,
        "memory_per_device": {
            "argument_bytes": _shard_bytes(specs, shardings),
            "output_bytes": int(at("output_bytes")),
            "temp_bytes": int(at("temp_bytes")),
            "alias_bytes": int(at("alias_bytes")),
        },
        "cost_per_device": cost,
        "collectives": coll,
        "cost_per_device_scanned": dict(cost),
        "collective_wire_bytes_scanned": wire,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_compress: bool = False, extrapolate: bool = True,
             microbatches: int = 1) -> Dict[str, Any]:
    """One cell's record on the production mesh of a fake world."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if reason:
        rec["skipped"] = reason
        return rec
    dims, _ = PRODUCTION[multi_pod]
    world = 1
    for d in dims:
        world *= d
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec["n_devices"] = mesh.size()
        rec["microbatches"] = microbatches
        rec.update(cell_cost(cfg, shape, mesh, opt_compress, microbatches,
                             extrapolate))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch, shape) on this mesh")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args()

    if args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    ok = True
    for arch, shape in cells:
        # the recurrent families already fit without accumulation
        mb = args.microbatches
        if get_config(arch).family in ("ssm", "hybrid"):
            mb = 1
        try:
            rec = run_cell(arch, shape, args.multi_pod, microbatches=mb)
        except Exception as e:  # a failing cell is a bug in the port
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if args.multi_pod else "16x16",
                   "error": f"{type(e).__name__}: {e}"}
            ok = False
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
