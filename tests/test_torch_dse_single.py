"""The port's single-pattern DSE (``dse.explore``) against the JAX
package's (``explore(p, cache=False)``): under the reference's TPU tier
every ``TilePlan`` field must match exactly -- tile sizes, depths,
traffic words, on-chip bytes, explored / pruned / thinned counts, and
the modeled seconds bitwise -- for every SUITE program at two sizes and
the paper's Table 2 filter and histogram, at the reference's budget and
at the H100's.  Also: plans cross the packages as JSON; at the H100
tier's plans for the chip_smoke shapes each kernel allocates exactly
the on-chip bytes the plan charges; and the programs no template takes
raise in the port as in the reference.
"""
import os
import sys

import numpy as np
import pytest

from repro.core import dse as jdse
from repro.core import ir as jir
from repro.core.codegen_pallas import lower as jlower
from repro.core.strip_mine import tile as jtile
from repro.patterns import analytics as jan

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, dse
from repro_torch.core.memory import plan_memory
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

sys.path.insert(0, os.path.dirname(__file__))
from test_core_transforms import mk_filter, mk_hist  # noqa: E402
from test_torch_cuda import NO_TEMPLATE, filter_program, hist_program  # noqa: E402

H100_BUDGET = cost.H100_SXM.onchip_bytes      # 232,448 B


def _fields(p):
    return (p.sizes, p.depths, p.traffic_words, p.vmem_bytes,
            p.modeled_seconds, p.explored, p.pruned, p.thinned)


# (name, reference builder, port builder) at two sizes each
PROGRAMS = [
    ("outerprod", lambda: jan.outerprod()[0], lambda: an.outerprod()[0]),
    ("outerprod-4096x2048", lambda: jan.outerprod(4096, 2048)[0],
     lambda: an.outerprod(4096, 2048)[0]),
    ("sumrows", lambda: jan.sumrows()[0], lambda: an.sumrows()[0]),
    ("sumrows-1024x512", lambda: jan.sumrows(1024, 512)[0],
     lambda: an.sumrows(1024, 512)[0]),
    ("gemm", lambda: jan.gemm()[0], lambda: an.gemm()[0]),
    ("gemm-512", lambda: jdse.gemm_program(512, 512, 512),
     lambda: dse.gemm_program(512, 512, 512)),
    ("tpchq6", lambda: jan.tpchq6()[0], lambda: an.tpchq6()[0]),
    ("tpchq6-6000000", lambda: jan.tpchq6(6_000_000)[0],
     lambda: an.tpchq6(6_000_000)[0]),
    ("gda", lambda: jan.gda()[0], lambda: an.gda()[0]),
    ("gda-4194304", lambda: jan.gda(n=4_194_304)[0],
     lambda: an.gda(n=4_194_304)[0]),
    ("kmeans", lambda: jan.kmeans()[0], lambda: an.kmeans()[0]),
    ("kmeans-4096", lambda: jan.kmeans(n=4096)[0],
     lambda: an.kmeans(n=4096)[0]),
    ("filter", lambda: mk_filter(), lambda: filter_program(40)),
    ("filter-6000000", lambda: mk_filter(6_000_000),
     lambda: filter_program(6_000_000)),
    ("hist", lambda: mk_hist(), lambda: hist_program(64, 8)),
    ("hist-1048576", lambda: mk_hist(1 << 20, 8),
     lambda: hist_program(1 << 20, 8)),
]
IDS = [name for name, _, _ in PROGRAMS]


def _explore_both(jbuild, tbuild, budget):
    try:
        want = _fields(jdse.explore(jbuild(), cache=False,
                                    vmem_budget=budget))
    except ValueError:
        want = ValueError
    try:
        got = _fields(dse.explore(tbuild(), tier=cost.TPU,
                                  vmem_budget=budget))
    except ValueError:
        got = ValueError
    return got, want


@pytest.mark.parametrize("budget", [None, H100_BUDGET])
@pytest.mark.parametrize("name,jbuild,tbuild", PROGRAMS, ids=IDS)
def test_explore_matches_the_reference(name, jbuild, tbuild, budget):
    got, want = _explore_both(jbuild, tbuild, budget)
    assert got == want


def test_most_programs_have_a_plan_at_the_cards_budget():
    """The budget case is not vacuous: only the 128^3 GEMM, whose K fold
    spans the whole extent, has no candidate within 232,448 B."""
    refused = [name for name, jb, tb in PROGRAMS
               if _explore_both(jb, tb, H100_BUDGET)[0] is ValueError]
    assert refused == ["gemm"]


@pytest.mark.parametrize("name,jbuild,tbuild", PROGRAMS[:6], ids=IDS[:6])
def test_plan_json_crosses_packages(name, jbuild, tbuild):
    want = jdse.explore(jbuild(), cache=False)
    got = dse.TilePlan.from_json(want.to_json())
    assert _fields(got) == _fields(want)
    assert dse.TilePlan.from_json(got.to_json()) == got
    # the same JSON, the reference's tuning-cache key and measured
    # fields included
    assert got.to_json() == want.to_json()
    back = jdse.TilePlan.from_json(
        dse.explore(tbuild(), tier=cost.TPU).to_json())
    assert _fields(back) == _fields(want)


def test_tuning_runtime_arguments_raise(tmp_path):
    """Bucketing, ``align`` and a cache path are taken as the reference
    takes them (a first bucketed call explores the shape)."""
    p = an.outerprod()[0]
    got = dse.explore(p, tier=cost.TPU, bucketing=True,
                      cache=str(tmp_path / "b.json"))
    want = jdse.explore(jan.outerprod()[0], bucketing=True,
                        cache=str(tmp_path / "jb.json"))
    assert _fields(got) == _fields(want) and not got.warm_start
    with pytest.raises(ValueError, match="measure"):
        dse.explore(p, tier=cost.TPU, measure="all")
    got = dse.explore(p, tier=cost.TPU, align=8, cache=False)
    want = jdse.explore(jan.outerprod()[0], align=8, cache=False)
    assert _fields(got) == _fields(want)
    path = str(tmp_path / "x.json")
    dse.explore(p, tier=cost.TPU, cache=path)
    assert dse.explore(p, tier=cost.TPU, cache=path).cached
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.explore(p, tier=cost.TPU, vmem_budget=64)


def test_grid_steps_and_tile_space():
    p = an.outerprod(512, 256)[0]
    assert dse.grid_steps(p, {"outer": (128, 64)}) == 16
    assert dse.tile_space(p) == {"outer": [
        (a, b) for a in (128, 256, 512) for b in (128, 256)]}


# ------------------------------------------- bytes allocated = charged
def _chip_shapes():
    return {"outerprod": an.outerprod(16384, 16384)[0],
            "gda": an.gda(n=4_194_304)[0],
            "filter": filter_program(6_000_000)}


# the plans the reference's DSE picks at the H100's budget
CHIP_PLANS = {"outerprod": ({"outer": (16384, 128)}, 2, 132_096),
              "gda": ({"gda": (2048,)}, 3, 222_336),
              "filter": ({"f": (16000,)}, 2, 192_000)}


@pytest.mark.parametrize("name", sorted(CHIP_PLANS))
def test_kernel_allocates_what_the_h100_plan_charges(name):
    p = _chip_shapes()[name]
    plan = dse.explore(p, tier=cost.H100_SXM)
    sizes, depth, nbytes = CHIP_PLANS[name]
    assert (plan.sizes, plan.depth, plan.vmem_bytes) == (sizes, depth, nbytes)
    t = tile(p, plan.sizes, vmem_budget_words=H100_BUDGET // 4)
    call = cc.lower(t, device="cpu", depth=plan.depth)
    assert call.kernel.spec.onchip_bytes == plan.vmem_bytes
    if name == "gda":   # the CAM's per-warp staging sits beside the charge
        spec = call.kernel.spec
        assert spec.staging_bytes == 9216
        assert spec.smem_bytes == plan.vmem_bytes + spec.staging_bytes \
            <= H100_BUDGET


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(CHIP_PLANS))
def test_kernel_allocates_what_plan_memory_charges(name, depth):
    p = _chip_shapes()[name]
    t = tile(p, CHIP_PLANS[name][0], vmem_budget_words=H100_BUDGET // 4)
    spec = cc.lower(t, device="cpu", depth=depth).kernel.spec
    assert spec.onchip_bytes == plan_memory(t, depth=depth).total_bytes


# ----------------------------------------------- programs with no template
def _reference_lowering(name):
    jp, sizes = {"sumrows": lambda: jan.sumrows()[:2],
                 "tpchq6": lambda: jan.tpchq6()[:2],
                 "kmeans": lambda: jan.kmeans()[:2],
                 "gemm_at_the_cards_budget": lambda: (
                     jdse.gemm_program(512, 512, 512),
                     {"gemm": (128, 512), "gemm_k": (512,)})}[name]()
    t = jtile(jp, sizes, vmem_budget_words=H100_BUDGET // 4)
    inputs = {x.name: np.ones(x.shape, np.float32)
              for x in jir.inputs_of(jp)}
    return jlower(t)(**inputs)


@pytest.mark.parametrize("name", sorted(NO_TEMPLATE))
def test_no_template_in_the_port_as_in_the_reference(name):
    with pytest.raises((NotImplementedError, AssertionError, TypeError)):
        _reference_lowering(name)
    p, sizes = NO_TEMPLATE[name]()
    with pytest.raises(NotImplementedError):
        cc.lower(tile(p, sizes, vmem_budget_words=H100_BUDGET // 4),
                 device="cpu")


def test_the_cards_gemm_plan_is_not_the_table3_form():
    """At 232,448 B the generic search tiles the GEMM as a write-once Map
    over per-element K folds, which no template takes -- in the
    reference as in the port.  So on the H100 tier ``lower_auto(gemm)``
    explores the tiled-GEMM template's own space
    (``dse.template_kernel``) and lowers to the template."""
    p = dse.gemm_program(512, 512, 512)
    plan = dse.explore(p, tier=cost.H100_SXM)
    assert plan.sizes == NO_TEMPLATE["gemm_at_the_cards_budget"]()[1]
    assert plan.sizes == jdse.explore(
        jdse.gemm_program(512, 512, 512), cache=False,
        vmem_budget=H100_BUDGET).sizes
    t = tile(p, plan.sizes, vmem_budget_words=H100_BUDGET // 4)
    assert not cc.match_tiled_gemm(t)
    call = cc.lower_auto(p, device="cpu", tier=cost.H100_SXM)
    assert call.tile_plan.sizes != plan.sizes
    assert "tgemm::launch<" in call.source
