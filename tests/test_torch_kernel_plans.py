"""The port's kernel selectors (``dse.select_*_blocks``) against the JAX
package's (``select_*(..., cache=False)``): under the reference's TPU
tier every field of the plan must match exactly -- blocks, traffic
words, on-chip bytes, explored and pruned counts, depths, and the
modeled seconds bitwise -- at the reference's budget (16 MiB) and at
the H100's (232,448 B).  The fixed point is the table below, which the
reference gives at those shapes.  Also: the proxy programs' torch bodies
evaluate as the reference's JAX bodies do, and the tuning-runtime
arguments are refused.
"""
import numpy as np
import pytest

from repro.core import codegen_jax as jex
from repro.core import dse as jdse
from repro.core import pipeline as jpl

from repro_torch.core import codegen_torch as tex
from repro_torch.core import cost, dse
from repro_torch.core import pipeline as pl

H100_BUDGET = cost.H100_SXM.onchip_bytes      # 232,448 B

# (selector, shape, budget) -> (blocks, on-chip bytes), from the reference
TABLE = {
    ("select_gemm_blocks", (512, 512, 512), None): ((512, 512, 512), 4194304),
    ("select_gemm_blocks", (512, 512, 512), H100_BUDGET):
        ((128, 512, 512), 8192),
    ("select_gemm_blocks", (4096, 4096, 4096), None):
        ((2048, 2048, 512), 16777216),
    ("select_gemm_blocks", (4096, 4096, 4096), H100_BUDGET):
        ((128, 512, 4096), 65536),
    ("select_filter_reduce_blocks", (6000000,), None): (80000, 2560000),
    ("select_filter_reduce_blocks", (6000000,), H100_BUDGET): (9600, 230400),
    ("select_filter_reduce_blocks", (4194304,), None): (131072, 3145728),
    ("select_filter_reduce_blocks", (4194304,), H100_BUDGET): (8192, 196608),
    ("select_fused_filter_fold_blocks", (4194304,), None): (131072, 4718592),
    ("select_fused_filter_fold_blocks", (4194304,), H100_BUDGET):
        (8192, 196608),
    ("select_fused_filter_fold_blocks", (6000000,), H100_BUDGET):
        (9600, 230400),
    ("select_groupby_blocks", (4194304, 64, 8), None): (16384, 1771520),
    ("select_groupby_blocks", (4194304, 64, 8), H100_BUDGET): (2048, 223232),
    ("select_groupby_blocks", (4194304, 8, 1), None): (131072, 3145760),
    ("select_groupby_blocks", (4194304, 8, 1), H100_BUDGET): (8192, 196640),
    ("select_fused_kmeans_blocks", (4194304, 8, 16), None): (8192, 1672224),
    ("select_fused_kmeans_blocks", (4194304, 8, 16), H100_BUDGET):
        (1024, 209952),
}


def _fields(plan):
    """The plan's JSON without the tuning cache's key, which the
    analytic port does not compute."""
    d = plan.to_json()
    d.pop("key")
    return d


@pytest.mark.parametrize("case", sorted(TABLE, key=str), ids=str)
def test_selector_matches_the_reference_exactly(case):
    name, shape, budget = case
    jblocks, jplan = getattr(jdse, name)(*shape, cache=False,
                                         vmem_budget=budget)
    blocks, plan = getattr(dse, name)(*shape, tier=cost.TPU,
                                      vmem_budget=budget)
    assert blocks == jblocks
    assert _fields(plan) == _fields(jplan)
    assert (blocks, plan.vmem_bytes) == TABLE[case]


def test_selectors_plan_for_the_card_off_the_card():
    """With no tier, a CPU device plans for the H100 datasheet tier,
    whose budget is the card's per-block shared memory."""
    got = dse.select_groupby_blocks(4194304, 64, 8, device="cpu")
    want = dse.select_groupby_blocks(4194304, 64, 8, tier=cost.TPU,
                                     vmem_budget=H100_BUDGET)
    assert got[0] == want[0] == 2048
    assert got[1].vmem_bytes == want[1].vmem_bytes


@pytest.mark.parametrize("name,shape", [
    ("select_gemm_blocks", (512, 512, 512)),
    ("select_filter_reduce_blocks", (4096,)),
    ("select_groupby_blocks", (4096, 8, 1)),
    ("select_fused_filter_fold_blocks", (4096,)),
    ("select_fused_kmeans_blocks", (4096, 8, 16)),
])
@pytest.mark.parametrize("arg", ["cache", "measure", "policy", "options"])
def test_selectors_refuse_the_tuning_runtime(name, shape, arg):
    with pytest.raises(NotImplementedError, match="tuning-runtime"):
        getattr(dse, name)(*shape, tier=cost.TPU, **{arg: "x"})


def test_plans_cross_the_packages_as_json():
    _, plan = dse.select_fused_kmeans_blocks(4096, 8, 16, tier=cost.TPU)
    back = jdse.PipelinePlan.from_json(plan.to_json())
    assert back.block == plan.block and back.depths == plan.depths
    _, tplan = dse.select_groupby_blocks(4096, 8, 4, tier=cost.TPU)
    assert dse.TilePlan.from_json(
        jdse.TilePlan.from_json(tplan.to_json()).to_json()) == tplan


def _inputs(shapes, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name == "keys":
            out[name] = rng.randint(0, 8, shape).astype(np.int32)
        else:
            out[name] = rng.randn(*shape).astype(np.float32)
    return out


def test_proxy_programs_evaluate_as_the_reference():
    t = 256
    inp = _inputs({"x": (t,), "w": (t,), "keys": (t,), "vals": (t, 3)})
    got = tex.execute(dse.filter_reduce_program(t), inp, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.execute(
        jdse.filter_reduce_program(t), inp)), rtol=2e-3, atol=2e-3)
    got = tex.execute(dse.groupby_program(t, 8, 3), inp, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.execute(
        jdse.groupby_program(t, 8, 3), inp)), rtol=2e-3, atol=2e-3)
    tpipe, jpipe = dse.filter_fold_pipeline(t), jdse.filter_fold_pipeline(t)
    assert pl.unfused_traffic_words(tpipe) == jpl.unfused_traffic_words(jpipe)
    env = dict(inp)
    for ts, js in zip(pl.topo_stages(tpipe), jpl.topo_stages(jpipe)):
        got = tex.execute(ts, env, device="cpu").numpy()
        np.testing.assert_allclose(got, np.asarray(jex.execute(js, env)),
                                   rtol=2e-3, atol=2e-3)
        env[ts.name] = got
