"""The port's fused pipeline path on the CPU (the fused-DAG kernel's plain
version) against the JAX package's ``lower_fused_pipeline`` (Pallas in
interpret mode) on the same seeded inputs: at the reference's own plan
carried across by ``PipelinePlan.from_json``, at a depth-4 plan and on
the split fallback, and the single-terminal ``lower_fused_chain``.
Also the megakernel's CAM semantics (out-of-range
keys dropped, kmeans ties to the first centroid), its generated source
(no atomics, streamed tiles through a ``cp.async`` ring), its CAM forms
and its shared-memory bytes: the plan's charge plus the CAM staging.
float32 rtol/atol 2e-3.
"""
import operator
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import ir as jir
from repro.core import pipeline as jpl
from repro.core.codegen_pallas import lower_fused_pipeline as jlower
from repro.patterns import analytics as jan

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, dse, ir, pipeline as pl
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import (CAM_SHAPES, keyed_inputs,  # noqa: E402
                             keyed_program, keyed_reference)

NAMES = sorted(an.PIPELINES)
TOL = dict(rtol=2e-3, atol=2e-3)
CARD_BYTES = cost.H100_SXM.onchip_bytes        # 232,448 B a block


def _dict(pipe_outputs, out):
    return out if isinstance(out, dict) else {pipe_outputs[0]: out}


def _compare(name, jplan_json):
    jpipe, make_inputs, _ = jan.PIPELINES[name]()
    tpipe = an.PIPELINES[name]()[0]
    inp = make_inputs()
    jkern = jlower(jpipe, plan=jdse.PipelinePlan.from_json(jplan_json))
    tkern = cc.lower_fused_pipeline(
        tpipe, plan=dse.PipelinePlan.from_json(jplan_json), tier=cost.TPU,
        device="cpu")
    assert tkern.group_lowerings == jkern.group_lowerings
    names = pl.output_names(tpipe)
    want = _dict(names, jkern(**inp))
    got = _dict(names, tkern(**inp))
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    return tkern


@pytest.mark.parametrize("name", NAMES)
def test_fused_path_at_the_reference_plan(name):
    jplan = jdse.explore_pipeline(jan.PIPELINES[name]()[0], cache=False)
    kern = _compare(name, jplan.to_json())
    assert kern.pipeline_plan.block == jplan.block
    assert all(how == "megakernel" for _, how in kern.group_lowerings)


@pytest.mark.parametrize("name", NAMES)
def test_fused_path_at_a_depth4_plan(name):
    n_stages = len(pl.topo_stages(an.PIPELINES[name]()[0]))
    plan = {"block": 128, "groups": [[0, n_stages]], "group_blocks": [128],
            "depths": [4], "traffic_words": 0, "unfused_traffic_words": 0,
            "vmem_bytes": 0, "modeled_seconds": 0.0}
    kern = _compare(name, plan)
    assert kern.group_calls[0].kernel.spec.depth == 4


def test_fused_path_on_the_split_fallback():
    jplan = jdse.explore_pipeline(jan.PIPELINES["gda"]()[0],
                                  vmem_budget=80_000, cache=False)
    assert not jplan.fused
    kern = _compare("gda", jplan.to_json())
    assert [how for _, how in kern.group_lowerings] == ["megakernel"] * 2


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_allocates_what_the_plan_charges(name, depth):
    pipe = an.PIPELINES[name]()[0]
    fd = pl.fuse_dag(pipe, 128)
    spec = cc.dag_spec(fd.terminals, fd.grid, depth)
    assert spec.onchip_bytes == pl.fused_memory_plan(
        pipe, 128, depth=depth).total_bytes


@pytest.mark.parametrize("name", NAMES)
def test_generated_source_is_deterministic_and_has_every_body(name):
    def source():
        fd = pl.fuse_dag(an.PIPELINES[name]()[0], 256)
        return cc.dag_source(cc.dag_spec(fd.terminals, fd.grid, 3))

    src = source()
    assert src == source()
    assert "constexpr int BLOCK = 256;" in src
    assert "constexpr int DEPTH = 3;" in src
    for s in an.PIPELINES[name]()[0].stages:
        for line in s.cuda.splitlines():
            assert line.strip() in src, (s.name, line)


# chip_smoke's shapes: each pipeline's CAM staging (bytes) beside the charge
# of its DSE plan for the card, and the single-pattern gda of lower_auto
CHIP_STAGING = {"tpchq6": 0, "gda": 9216, "kmeans": 5120, "gda_moments": 0,
                "normalize": 0, "lower_auto[gda]": 9216}


def _chip_spec(name):
    """The megakernel spec and plan charge chip_smoke runs for ``name``,
    planned for the card's budget on the CPU."""
    if name == "lower_auto[gda]":
        call = cc.lower_auto(an.gda(n=4_194_304)[0], device="cpu",
                             tier=cost.H100_SXM)
        return call.kernel.spec, call.tile_plan.vmem_bytes
    n = 6_000_000 if name == "tpchq6" else 4_194_304
    call = cc.lower_fused_pipeline(an.PIPELINES[name](n=n)[0], device="cpu",
                                   tier=cost.H100_SXM)
    (group,) = call.group_calls
    return group.kernel.spec, call.pipeline_plan.vmem_bytes


@pytest.mark.parametrize("name", sorted(CHIP_STAGING))
def test_chip_plans_take_the_register_form_beside_their_charge(name):
    spec, charge = _chip_spec(name)
    cams = [t for t in spec.terminals if t.kind == "cam"]
    assert all(t.cam_form == "register" for t in cams)
    assert spec.onchip_bytes == charge
    assert spec.staging_bytes == CHIP_STAGING[name]
    assert spec.smem_bytes == charge + spec.staging_bytes <= CARD_BYTES


def test_dag_spec_raises_when_the_staging_does_not_fit():
    fd = pl.fuse_dag(an.PIPELINES["gda"](n=4096)[0], 256)
    spec = cc.dag_spec(fd.terminals, fd.grid, 3)
    assert spec.staging_bytes > 0
    fits = spec.onchip_bytes + spec.staging_bytes
    assert cc.dag_spec(fd.terminals, fd.grid, 3, smem_limit=fits) == spec
    with pytest.raises(ValueError, match=f"charges {spec.onchip_bytes} B "
                       f"and its CAM staging needs {spec.staging_bytes} B"):
        cc.dag_spec(fd.terminals, fd.grid, 3, smem_limit=fits - 4)


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_generated_source_has_no_atomics_and_a_cp_async_ring(name, depth):
    fd = pl.fuse_dag(an.PIPELINES[name]()[0], 256)
    spec = cc.dag_spec(fd.terminals, fd.grid, depth)
    src = cc.dag_source(spec)
    assert src == cc.dag_source(cc.dag_spec(fd.terminals, fd.grid, depth))
    assert "atomic" not in src and "cam_add" not in src
    assert "copy_vec4" not in src
    streams = [i for i, b in enumerate(spec.buffers) if b.kind == "stream"]
    assert streams
    for i in streams:   # once ahead of the walk, once a step
        assert src.count(f"fdag::copy_async(buf{i} + ") == 2
    assert "hop::cp_async_wait<DEPTH - 2>();" in src


@pytest.mark.parametrize("case", CAM_SHAPES, ids=str)
def test_cam_forms_of_each_shape_class(case):
    form, lanes, k, ew, block = case
    n = 8 * block
    call = cc.lower(tile(keyed_program(n, k, ew), {"kv": (block,)}),
                    device="cpu")
    (t,) = call.kernel.spec.terminals
    assert (t.cam_form, t.cam_lanes) == (form, lanes)
    pieces = -(-ew // lanes) if form == "register" else 0
    assert k * pieces <= cc.CAM_REG_WORDS
    host = keyed_inputs(n, k, ew, seed=k + ew)
    got = call(**host)
    np.testing.assert_allclose(got.numpy(), keyed_reference(host, k),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tables,want", [
    ([(4, 72)], [("register", 8)]),
    ([(8, 1), (8, 16)], [("register", 1), ("register", 4)]),
    ([(4, 8), (4, 8)], [("register", 1), ("register", 1)]),
    ([(64, 1)], [("register", 1)]),
    ([(64, 32)], [("register", 32)]),
    ([(65, 1)], [("shared", 32)]),
    ([(64, 1), (1, 1)], [("shared", 32), ("register", 1)]),
])
def test_cam_forms_share_the_register_limit(tables, want):
    assert cc.cam_forms(tables) == want


# ------------------------------------------------------- CAM semantics
def _hist(n, k, lib):
    """keys Map -> keyed count, as a pipeline of either package."""
    if lib == "jax":
        x = jir.Tensor("x", (n,))
        keys = jir.Map(domain=(n,), reads=(jir.elem(x),),
                       fn=lambda s, e: e, name="keys")
        hist = jir.GroupByFold(
            domain=(n,), num_keys=k, elem_shape=(),
            init=lambda: jnp.zeros((k,)),
            reads=(jir.elem(jir.Tensor("keys", (n,))),),
            fn=lambda s, e: (e.astype(jnp.int32), jnp.float32(1.0)),
            combine=lambda a, b: a + b, name="hist")
        return jpl.Pipeline(name="hist", stages=(keys, hist))
    x = ir.Tensor("x", (n,))
    keys = ir.Map(domain=(n,), reads=(ir.elem(x),), fn=lambda s, e: e,
                  cuda="out[0] = in0[0];", name="keys")
    hist = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(),
        init=lambda: torch.zeros((k,)),
        reads=(ir.elem(ir.Tensor("keys", (n,))),),
        fn=lambda s, e: (e.to(torch.int32), torch.ones_like(e)),
        combine=operator.add, cuda="key = (int)in0[0];\nout[0] = 1.0f;",
        name="hist")
    return pl.Pipeline(name="hist", stages=(keys, hist))


def test_cam_drops_out_of_range_keys():
    n, k = 256, 8
    rng = np.random.RandomState(3)
    xs = rng.randint(-3, k + 3, n).astype(np.float32)
    xs[:4] = [-1.0, float(k), -0.5, k + 0.5]   # -0.5 truncates to key 0
    keep = xs.astype(np.int32)
    want = np.bincount(keep[(keep >= 0) & (keep < k)], minlength=k)
    got = cc.lower_fused_pipeline(_hist(n, k, "torch"), device="cpu")(x=xs)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    jgot = jlower(_hist(n, k, "jax"), cache=False)(x=jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_kmeans_ties_go_to_the_first_centroid():
    n, k, d = 256, 8, 16
    pipe, make_inputs, ref = an.PIPELINES["kmeans"](n=n, k=k, d=d)
    inp = make_inputs()
    cents = inp["centroids"]
    cents[1] = cents[0]                     # exact duplicate: index 0 wins
    cents[3] = -cents[2]                    # +-c: a point at 0 ties
    inp["points"][:8] = 0.0
    inp["points"][:4] = cents[0]
    got = cc.lower_fused_pipeline(pipe, device="cpu")(**inp)
    want = ref(inp)
    jgot = jlower(jan.PIPELINES["kmeans"](n=n, k=k, d=d)[0],
                  cache=False)(**{k_: jnp.asarray(v) for k_, v in inp.items()})
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], **TOL)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(jgot[name]),
                                   **TOL)
    assert got["km_counts"][1] == 0          # the duplicate never wins


def test_non_additive_terminal_runs_the_oracle_chain():
    n = 256
    x = ir.Tensor("x", (n,))
    sq = ir.Map(domain=(n,), reads=(ir.elem(x),), fn=lambda s, e: e * e,
                cuda="out[0] = in0[0] * in0[0];", name="sq")
    top = ir.MultiFold(
        domain=(n,), range_shape=(), init=lambda: torch.tensor(0.0),
        reads=(ir.elem(ir.Tensor("sq", (n,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: torch.maximum(acc, v), combine=torch.maximum,
        cuda="out[0] = in0[0];", name="top")
    pipe = pl.Pipeline(name="max", stages=(sq, top))
    xs = np.random.RandomState(0).randn(n).astype(np.float32)
    kern = cc.lower_fused_pipeline(pipe, device="cpu")
    assert kern.group_lowerings == (("top", "oracle-chain"),)
    np.testing.assert_allclose(float(kern(x=xs)), float((xs * xs).max()),
                               rtol=1e-6)


@pytest.mark.parametrize("depth", [2, 4])
def test_fused_chain_matches_the_reference(depth):
    from repro.core.codegen_pallas import lower_fused_chain as jchain

    jpipe, make_inputs, _ = jan.PIPELINES["tpchq6"]()
    tpipe = an.PIPELINES["tpchq6"]()[0]
    inp = make_inputs()
    ((_, jp),) = jpl.fuse_dag(jpipe, 256).terminals
    ((_, tp),) = pl.fuse_dag(tpipe, 256).terminals
    want = jchain(jp, depth=depth)(**inp)
    got = cc.lower_fused_chain(tp, depth=depth, device="cpu")(**inp)
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
