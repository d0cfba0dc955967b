"""The ranks of ``test_torch_dist.py``'s multi-rank test: gloo over a
``FileStore`` (no TCP port is named), a 2x2 ("data", "model") CPU mesh.

Each rank runs a float32 train step of granite-3-2b, Mixtral and Mamba-2
SMOKE on DTensor parameters placed by ``shard_rules`` (the batch by
``batch_sharding``, the hints on), once as written and once with a
planted fault -- rank 1 keeps its own gradient partials where the
others reduce them over "data" -- and granite once more with another:
one leaf's gradient reduced and then doubled on every rank.  Besides the
updated parameters it keeps the gradients ``adamw.update`` is given and
the first moments after the step (``0.1 * clip scale * gradient``),
which a first Adam step's parameters, moved by about ``lr * sign(g)``,
cannot show the size of.  Then it saves the first step's
parameters (a checkpoint written on 2x2) and restores them with
``shardings=`` onto a 4x1 mesh (ZeRO-3: weights sharded over "data").
It writes every full tensor it sees to ``rank<r>.pt``.  No JAX here:
the ranks import the port alone.
"""
from __future__ import annotations

import os

import numpy as np

ARCHS = ("granite-3-2b", "mixtral-8x22b", "mamba2-370m")
ROWS, SEQ = 4, 16
LR = 1e-2   # a first Adam step moves each weight by about lr: a sign
            # flip of a gradient shows at 2 lr, far above 2e-3
DOUBLED = "w2"   # the leaf whose reduced gradient the second fault doubles


def config(arch):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True).with_(dtype="float32")


def opt_config():
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def batch(cfg, seed=0):
    """Seeded tokens and labels, (ROWS, SEQ) int32 numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (ROWS, SEQ), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (ROWS, SEQ), dtype=np.int32)
    return {"tokens": toks, "labels": labels}


def full(t):
    """A plain copy of ``t``, gathered where it is a DTensor."""
    from repro_torch.models.sharding import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t.detach().clone()


def _captured(step, *args):
    """``step(*args)`` with the gradients ``adamw.update`` is given kept:
    (loss, params, gradients, first moments), each tensor gathered."""
    from repro_torch.optim import adamw

    update, seen = adamw.update, {}

    def keep(grads, *a, **k):
        seen.update({n: full(grads[n]) for n in sorted(grads)})
        return update(grads, *a, **k)
    adamw.update = keep
    try:
        loss, params, state = step(*args)
    finally:
        adamw.update = update
    return (float(full(loss)), {k: full(v) for k, v in params.items()},
            seen, {k: full(v) for k, v in state.m.items()})


def plain_step(arch):
    """The one-process step on the CPU: (loss, updated params,
    gradients, first moments)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw

    cfg = config(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    state = adamw.init(params, opt_config())
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    return _captured(steps.make_train_step(cfg, opt_config()), params,
                     state, b)


def _unreduced_on(rank_to_fault: int):
    """``steps.value_and_grad`` whose gradients are reduced over "data"
    on every rank (the same collectives everywhere), after which rank
    ``rank_to_fault`` puts its own partials back in their place."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import steps

    plain = steps.value_and_grad

    def faulty(params, cfg, b):
        loss, grads = plain(params, cfg, b)
        out = {}
        for k, g in grads.items():
            if not g.placements[0].is_partial():
                out[k] = g
                continue
            want = (Replicate(),) + tuple(g.placements[1:])
            reduced = g.redistribute(g.device_mesh, want)
            if dist.get_rank() == rank_to_fault:
                reduced = DTensor.from_local(g.to_local(), g.device_mesh,
                                             want, run_check=False)
            out[k] = reduced
        return loss, out
    return faulty


def _doubled(name: str):
    """``steps.value_and_grad`` whose gradient of ``name`` is reduced
    and then doubled, on every rank (as a sum taken where a mean is
    meant, over two data ranks)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.launch import steps

    plain = steps.value_and_grad

    def faulty(params, cfg, b):
        loss, grads = plain(params, cfg, b)
        g = grads[name]
        want = tuple(Replicate() if p.is_partial() else p
                     for p in g.placements)
        grads[name] = g.redistribute(g.device_mesh, want) * 2
        return loss, grads
    return faulty


FAULTS = {"unreduced": lambda: _unreduced_on(1),
          "doubled": lambda: _doubled(DOUBLED)}


def meshed_step(arch, mesh, fault=None):
    """The step on ``mesh``, with the planted ``fault`` (a key of
    FAULTS) or none: as ``plain_step``'s, gathered."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shard_rules, steps
    from repro_torch.models import model
    from repro_torch.models.sharding import use_mesh_hints
    from repro_torch.optim import adamw

    cfg = config(arch)
    full = model.init_params(cfg, seed=0, device="cpu")
    psh = shard_rules.param_sharding(cfg, mesh, full)
    params = {k: distribute_tensor(v, mesh, list(psh[k].placements))
              for k, v in full.items()}
    opt = opt_config()
    ospec = adamw.state_specs(full, opt)
    osh = shard_rules.opt_state_sharding(cfg, mesh, full, ospec)
    zeros = adamw.init(full, opt)
    state = adamw.AdamWState(
        distribute_tensor(zeros.step, mesh, list(osh.step.placements)),
        {k: distribute_tensor(v, mesh, list(osh.m[k].placements))
         for k, v in zeros.m.items()},
        {k: distribute_tensor(v, mesh, list(osh.v[k].placements))
         for k, v in zeros.v.items()}, None)
    host = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    bsh = shard_rules.batch_sharding(mesh, host)
    b = {k: distribute_tensor(v, mesh, list(bsh[k].placements))
         for k, v in host.items()}
    step = steps.make_train_step(cfg, opt, grad_shardings=psh)
    keep = steps.value_and_grad
    if fault:
        steps.value_and_grad = FAULTS[fault]()
    try:
        with use_mesh_hints(mesh):
            return _captured(step, params, state, b)
    finally:
        steps.value_and_grad = keep


def main(rank: int, world: int, where: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import manager
    from repro_torch.launch import shard_rules
    from repro_torch.launch.mesh import make_elastic_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(where, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        for arch in ARCHS:
            faults = (None, "unreduced") + (("doubled",)
                                            if arch == ARCHS[0] else ())
            for fault in faults:
                loss, params, grads, m = meshed_step(arch, mesh, fault)
                out[f"{arch}/{fault}" if fault else arch] = {
                    "loss": loss, "params": params, "grads": grads, "m": m}
        # the first step's parameters, as a checkpoint written on 2x2
        cfg = config(ARCHS[0])
        psh = shard_rules.param_sharding(cfg, mesh, out[ARCHS[0]]["params"])
        written = {k: distribute_tensor(v, mesh, list(psh[k].placements))
                   for k, v in out[ARCHS[0]]["params"].items()}
        ckpt = os.path.join(where, "ckpt")
        manager.save(ckpt, 1, written)
        other = make_elastic_mesh(list(range(world)), model_parallel=1,
                                  device_type="cpu")
        # ZeRO-3 on the survivors' (4, 1) mesh: weights over "data"
        cfg = cfg.with_(fsdp=True)
        sh = shard_rules.param_sharding(cfg, other, written)
        back = manager.restore(ckpt, 1, written, shardings=sh)
        out["restored"] = {
            "mesh": tuple(other.shape),
            "placements": {k: tuple(repr(p) for p in v.placements)
                           for k, v in back.items()},
            "params": {k: v.full_tensor() for k, v in back.items()}}
        torch.save(out, os.path.join(where, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
