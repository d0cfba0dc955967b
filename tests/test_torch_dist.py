"""Distribution on ``torch.distributed``: the dry run on a fake world
(``repro_torch.launch.dryrun``) against the reference's shardings and
record, and one multi-rank numeric test (gloo over a ``FileStore``, four
ranks, ``torch_dist_ranks``): 2x2 train steps of granite-3-2b, Mixtral
and Mamba-2 SMOKE against the one-process step (parameters, gradients
and first moments), two planted faults (an unreduced gradient, a doubled
one), and a checkpoint restored across meshes."""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import AbstractMesh

import torch_dist_ranks as ranks
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import shard_rules as ref_rules
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, mesh as tmesh

TOL = 2e-3          # f32 rtol / atol of the reference's tests
DEADLINE_S = 120    # the multi-rank test's join deadline

FAMILIES = {"dense": "granite-3-2b", "moe": "mixtral-8x22b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
            "audio": "musicgen-medium", "vlm": "internvl2-1b"}
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
# the cells' shapes cut to a size that traces in seconds (rows, tokens):
# the same kinds, both packages at the same shape
CUT = {"train": (8, 256), "prefill": (4, 512), "decode": (8, 512)}


def _shape(kind, shape_cls):
    rows, seq = CUT[kind]
    return shape_cls(KINDS[kind], kind, seq, rows)


@pytest.fixture(autouse=True)
def _no_group_left_behind():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a default group"


@pytest.fixture
def fake_2x2():
    """A (2, 2) ("data", "model") CPU mesh on a fake world of 4 ranks;
    the group is destroyed whatever the test does."""
    from torch.distributed.device_mesh import init_device_mesh

    with tmesh.fake_world(4):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


def test_fake_world_refuses_a_second_group_and_always_ends():
    with pytest.raises(ZeroDivisionError):
        with tmesh.fake_world(8):
            assert dist.get_world_size() == 8
            with pytest.raises(RuntimeError):
                with tmesh.fake_world(8):
                    pass
            1 / 0
    assert not dist.is_initialized()


def _ref_argument_bytes(arch, shape_name):
    """Bytes of the local shards of the reference's step arguments, by
    ``NamedSharding.shard_shape`` on ``AbstractMesh((2, 2))``."""
    import jax

    amesh = AbstractMesh((2, 2), ("data", "model"))
    cfg = ref_config(arch, smoke=True)
    shape = _shape(REF_SHAPES[shape_name].kind, type(REF_SHAPES[shape_name]))
    pspecs = ref_model.param_specs(cfg)
    psh = ref_rules.param_sharding(cfg, amesh, pspecs)
    bspecs = ref_steps.input_specs(cfg, shape)
    bsh = ref_rules.batch_sharding(amesh, bspecs)
    if shape.kind == "train":
        ospecs = ref_adamw.state_specs(pspecs, ref_adamw.AdamWConfig())
        osh = ref_rules.opt_state_sharding(cfg, amesh, pspecs, ospecs)
        specs, shs = (pspecs, ospecs, bspecs), (psh, osh, bsh)
    elif shape.kind == "prefill":
        specs, shs = (pspecs, bspecs), (psh, bsh)
    else:
        cspecs, ispec = ref_steps.decode_extras(cfg, shape)
        csh = ref_rules.cache_sharding(cfg, amesh, cspecs)
        scalar = jax.sharding.NamedSharding(amesh,
                                            jax.sharding.PartitionSpec())
        specs = (pspecs, cspecs, bspecs["tokens"], ispec)
        shs = (psh, csh, bsh["tokens"], scalar)
    total = 0
    for spec, sh in zip(jax.tree.leaves(specs), jax.tree.leaves(shs)):
        total += int(np.prod(sh.shard_shape(spec.shape))) \
            * np.dtype(spec.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def ref_record_keys():
    """The reference's record keys: its ``run_cell`` on granite SMOKE,
    on a (1, 1) mesh of this process's one CPU device, per step kind.
    (``repro.launch.dryrun`` sets XLA_FLAGS when imported: kept from
    reaching later processes.)"""
    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref_dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    keys = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref_dryrun, "get_config",
                   lambda arch: ref_config(arch, smoke=True))
        from repro.launch.mesh import _axis_type_kwargs

        mp.setattr(ref_dryrun, "make_production_mesh",
                   lambda multi_pod=False: jax.make_mesh(
                       (1, 1), ("data", "model"), **_axis_type_kwargs(2)))
        for kind, shape in KINDS.items():
            mp.setitem(ref_dryrun.SHAPES, shape,
                       _shape(kind, type(REF_SHAPES[shape])))
            rec = ref_dryrun.run_cell("granite-3-2b", shape, False)
            keys[kind] = _keys(rec)
    finally:
        mp.undo()
    return keys


def _keys(rec):
    """A record's keys, nested ones as ``outer.inner``."""
    out = set()
    for k, v in rec.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk, vv in v.items()}
            out |= {f"{k}.{kk}.{kkk}" for kk, vv in v.items()
                    if isinstance(vv, dict) for kkk in vv}
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dryrun_cell_on_a_fake_2x2(family, kind, fake_2x2,
                                   ref_record_keys):
    arch = FAMILIES[family]
    shape = _shape(kind, type(SHAPES[KINDS[kind]]))
    cfg = get_config(arch, smoke=True)
    rec = {"arch": arch, "shape": shape.name, "mesh": "2x2",
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "n_devices": fake_2x2.size(), "microbatches": 1}
    rec.update(dryrun.cell_cost(cfg, shape, fake_2x2))
    assert "error" not in rec
    assert _keys(rec) == ref_record_keys[kind]
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] == _ref_argument_bytes(arch, shape.name)
    assert mem["temp_bytes"] > 0 and rec["cost_per_device"]["flops"] > 0
    # the weights are sharded over "model" and the batch over "data":
    # the step must move something
    assert sum(v["count"] for k, v in rec["collectives"].items()
               if isinstance(v, dict)) > 0
    assert rec["collective_wire_bytes_scanned"]["total"] > 0
    if kind == "train":   # the step updates parameters and state in place
        specs, shardings = dryrun.cell_inputs(cfg, shape, fake_2x2)
        assert mem["alias_bytes"] == mem["argument_bytes"] \
            - dryrun._shard_bytes(specs[2], shardings[2])


def test_dryrun_cli_writes_the_record(tmp_path, monkeypatch, capsys):
    """``main`` on a SMOKE config (the production 16x16 mesh of a fake
    world): the record printed and appended, exit 0."""
    import json
    import sys

    out = tmp_path / "cells.jsonl"
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "granite-3-2b",
                                      "--shape", "decode_32k",
                                      "--out", str(out)])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory_per_device"]["argument_bytes"] > 0


def test_dryrun_cli_reports_a_failing_cell(monkeypatch, capsys):
    import json
    import sys

    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "granite-3-2b",
                                      "--shape", "train_4k", "--multi-pod"])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 1
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec == {"arch": "granite-3-2b", "shape": "train_4k",
                   "mesh": "2x16x16", "error": "RuntimeError: planted"}


def test_grad_shardings_leave_a_plain_step_unchanged():
    """``make_train_step(grad_shardings=)`` with plain parameters (two
    microbatches, so the accumulators are pinned): bit for bit the step
    without it."""
    from repro_torch.launch import shard_rules, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw

    cfg = ranks.config("granite-3-2b")
    b = {k: torch.from_numpy(v) for k, v in ranks.batch(cfg).items()}
    psh = shard_rules.param_sharding(cfg, {"data": 2, "model": 2},
                                     model.param_specs(cfg))
    out = []
    for sh in (None, psh):
        params = model.init_params(cfg, seed=0, device="cpu")
        state = adamw.init(params, ranks.opt_config())
        step = steps.make_train_step(cfg, ranks.opt_config(),
                                     microbatches=2, grad_shardings=sh)
        out.append(step(params, state, b)[:2])
    (loss0, p0), (loss1, p1) = out
    assert torch.equal(loss0, loss1)
    for k, v in p0.items():
        assert torch.equal(p1[k], v), k


def _close(got, want):
    """max |got - want| over rtol TOL / atol TOL: within when <= 1."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Run ``torch_dist_ranks.main`` on 4 spawned ranks; kill them and
    fail if they have not all ended within DEADLINE_S."""
    where = tmp_path_factory.mktemp("ranks")
    ctx = tmp.start_processes(ranks.main, args=(4, str(where)), nprocs=4,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the ranks did not end within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(where / f"rank{r}.pt") for r in range(4)]


def _worst(got, want, scaled=False):
    """The largest ``_close`` over the leaves of ``want``.  ``scaled``:
    each leaf pair first divided by the largest |value| of ``want``'s
    leaf, for gradients and moments, whose values lie far below the
    rule's atol (a gradient of 1e-4 doubled would pass it unscaled)."""
    def one(g, w):
        s = w.abs().max().clamp_min(torch.finfo(w.dtype).tiny)
        return _close(g / s, w / s) if scaled else _close(g, w)
    return max(one(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_2x2_train_step_equals_the_one_process_step(arch, four_ranks):
    loss, params, grads, m = ranks.plain_step(arch)
    # first: the limit rejects rank 1 keeping its own gradient partials,
    # where the others reduce them over "data"
    faulted = four_ranks[1][f"{arch}/unreduced"]
    assert _worst(faulted["params"], params) > 1.0
    assert _worst(faulted["grads"], grads, scaled=True) > 1.0
    # the parameters, the gradients the optimizer is given and its first
    # moments (their size, the clip scale's too, which a first Adam
    # step's parameters cannot show)
    assert sorted(grads) == sorted(params) == sorted(m)
    for got in four_ranks:
        mine = got[arch]
        assert abs(mine["loss"] - loss) <= TOL + TOL * abs(loss)
        assert _worst(mine["params"], params) <= 1.0
        for name, want in (("grads", grads), ("m", m)):
            worst = _worst(mine[name], want, scaled=True)
            assert worst <= 1.0, (name, worst)


def test_the_limit_rejects_a_doubled_reduced_gradient(four_ranks):
    """One leaf's gradient reduced and then doubled on every rank: the
    gradients and the first moments fall outside the limit."""
    arch = ranks.ARCHS[0]
    _, _, grads, m = ranks.plain_step(arch)
    for got in four_ranks:
        faulted = got[f"{arch}/doubled"]
        assert _worst(faulted["grads"], grads, scaled=True) > 1.0
        assert _worst(faulted["m"], m, scaled=True) > 1.0


def test_checkpoint_restored_across_meshes_is_bitwise(four_ranks):
    saved = four_ranks[0][ranks.ARCHS[0]]["params"]
    for got in four_ranks:
        back = got["restored"]
        assert back["mesh"] == (4, 1)
        # ZeRO-3 on the survivors: weights sharded over "data" (4 ranks)
        assert any(pl[0].startswith("Shard")
                   for pl in back["placements"].values())
        assert sorted(back["params"]) == sorted(saved)
        for k, v in saved.items():
            assert torch.equal(back["params"][k], v), k
