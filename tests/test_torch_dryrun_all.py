"""The dry run's ``--all`` records (``repro_torch.launch.dryrun.run_cell``)
held to the reference's (``repro.launch.dryrun.run_cell``) for every
(arch, shape) of ``configs.ARCHS`` x ``SHAPES`` on both production meshes
(16x16 and 2x16x16): the fields both packages compute on the host --
``arch``, ``shape``, ``mesh``, ``params``, ``active_params``, ``skipped``
(its text), ``n_devices``, ``microbatches``, ``model_flops`` and
``memory_per_device.argument_bytes`` -- exactly.

Nothing is compiled or run on either side.  The port's record is its own
``run_cell`` on the fake production world with the step itself
(``dryrun._run_step``) replaced by zero counts: the record's argument
bytes come from the shard shapes whatever the step counts.  The
reference's is its own ``run_cell`` with its compile
(``_lower_and_cost``) replaced by the host's share of it: ``model_flops``
by the reference's formula, and the argument bytes of its shard shapes
on ``jax.sharding.AbstractMesh`` (``NamedSharding.shard_shape``), the
yardstick ``test_torch_shard_rules.py`` uses; its compiled
``memory_analysis`` would read the same bytes.  The counted fields
(flops, temp bytes, collectives) differ by design: XLA's cost analysis
of the compiled HLO there, a dispatch-mode count on meta shards here.
"""
import os
import types

import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import shard_rules as ref_rules
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
HOST_FIELDS = ("arch", "shape", "mesh", "params", "active_params",
               "skipped", "n_devices", "microbatches", "model_flops")


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS (512
    host devices) for processes started later: the backend is started
    first and the variable put back, so nothing else sees it."""
    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def _ref_host_cost(cfg, shape, mesh, opt_compress, microbatches=1):
    """The host's share of the reference's ``_lower_and_cost``: its
    ``model_flops`` and the bytes of the step arguments' shards."""
    amesh = mesh.abstract
    pspecs = ref_model.param_specs(cfg)
    psh = ref_rules.param_sharding(cfg, amesh, pspecs)
    bspecs = ref_steps.input_specs(cfg, shape)
    bsh = ref_rules.batch_sharding(amesh, bspecs)
    if shape.kind == "train":
        ospecs = ref_adamw.state_specs(
            pspecs, ref_adamw.AdamWConfig(compress_grads=opt_compress))
        osh = ref_rules.opt_state_sharding(cfg, amesh, pspecs, ospecs)
        specs, shs = (pspecs, ospecs, bspecs), (psh, osh, bsh)
        flops = cfg.model_flops(shape.global_batch * shape.seq_len,
                                training=True)
    elif shape.kind == "prefill":
        specs, shs = (pspecs, bspecs), (psh, bsh)
        flops = cfg.model_flops(shape.global_batch * shape.seq_len,
                                training=False)
    else:
        cspecs, ispec = ref_steps.decode_extras(cfg, shape)
        csh = ref_rules.cache_sharding(cfg, amesh, cspecs)
        specs = (pspecs, cspecs, bspecs["tokens"], ispec)
        shs = (psh, csh, bsh["tokens"], NamedSharding(amesh, PartitionSpec()))
        flops = cfg.model_flops(shape.global_batch, training=False)
    import jax

    spec_leaves, sh_leaves = jax.tree.leaves(specs), jax.tree.leaves(shs)
    assert len(spec_leaves) == len(sh_leaves)
    arg = sum(int(np.prod(sh.shard_shape(spec.shape)))
              * np.dtype(spec.dtype).itemsize
              for spec, sh in zip(spec_leaves, sh_leaves))
    return {"model_flops": flops,
            "memory_per_device": {"argument_bytes": arg}}


def _ref_record(ref_dryrun, arch, shape, multi_pod, monkeypatch):
    dims, names = MESHES[multi_pod]

    def production(*, multi_pod=False):
        assert multi_pod == (len(dims) == 3)
        return types.SimpleNamespace(devices=np.empty(dims, object),
                                     abstract=AbstractMesh(dims, names))
    monkeypatch.setattr(ref_dryrun, "make_production_mesh", production)
    monkeypatch.setattr(ref_dryrun, "_lower_and_cost", _ref_host_cost)
    return ref_dryrun.run_cell(arch, shape, multi_pod, extrapolate=False)


def _zero_step(*args, **kwargs):
    """The step's counts, all zero: the step is not run."""
    return {"secs": 0.0, "flops": 0.0, "bytes_accessed": 0.0,
            "temp_bytes": 0, "output_bytes": 0, "alias_bytes": 0,
            "collectives": {k: {"operand_bytes": 0, "result_bytes": 0,
                                "ring_wire_bytes": 0.0, "count": 0}
                            for k in dryrun.COLLECTIVES}}


def test_the_sweep_covers_the_same_cells():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert sorted(SHAPES) == sorted(REF_SHAPES)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_all_record_matches_the_reference(arch, shape, multi_pod,
                                          ref_dryrun, monkeypatch):
    want = _ref_record(ref_dryrun, arch, shape, multi_pod, monkeypatch)
    monkeypatch.setattr(dryrun, "_run_step", _zero_step)
    got = dryrun.run_cell(arch, shape, multi_pod)
    for key in HOST_FIELDS:
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == want[key], key
    if "skipped" in want:
        assert set(got) == set(want)
    else:
        assert got["memory_per_device"]["argument_bytes"] \
            == want["memory_per_device"]["argument_bytes"]
        assert got["n_devices"] == int(np.prod(MESHES[multi_pod][0]))
