"""The port's kernel selectors (``dse.select_*_blocks``) against the JAX
package's (``select_*(..., cache=False)``): under the reference's TPU
tier every field of the plan must match exactly -- blocks, traffic
words, on-chip bytes, explored and pruned counts, depths, and the
modeled seconds bitwise -- at the reference's budget (16 MiB) and at
the H100's (232,448 B).  The fixed point is the table below, which the
reference gives at those shapes.  Also: the proxy programs' torch bodies
evaluate as the reference's JAX bodies do, and the tuning-runtime
arguments (shape-bucketed warm starts among them) are taken.

Under the H100's tier the attention and SSD selectors plan the hand
kernels' own axes (``dse.KernelSpace``): a plan at every head dim (64,
80, 128), prefill length (128..8192) and decode context (256..32,768),
and at every SSD state (128, 64) and length (256..8192), each one the
kernel launches and charged the shared bytes it allocates
(``codegen_cuda.fa_smem_bytes``, ``ssd_scan.layout``), which equal the
byte counts evaluated from ``flash_attention.cuh`` and ``ssd_scan.cuh``.
"""
import dataclasses
import re
from pathlib import Path

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
    """Every selector takes the tuning runtime's arguments (an analytic
    plan is the same with or without a cache, a policy or shape-bucketed
    warm starts, whose first call for a shape explores it)."""
    import functools
    call = functools.partial(getattr(dse, name), *shape, tier=cost.TPU)
    from repro_torch.core import resilience
    from repro_torch.core.options import Options
    if arg == "options":      # bucketing: a miss explores, as without
        blocks, plan = call(options=Options(bucketing=True))
        assert blocks == call(cache=False)[0] and not plan.warm_start
        return
    if arg == "measure":      # validated as the reference validates it
        with pytest.raises(ValueError, match="measure"):
            call(measure="x")
        return
    value = {"cache": False, "policy": resilience.Policy(timeout_s=0)}[arg]
    got = call(**{arg: value})
    want = call(cache=False)
    assert got[0] == want[0]
    assert got[1].to_json() == dict(want[1].to_json(), key=got[1].key)


def test_plans_cross_the_packages_as_json():
    _, plan = dse.select_fused_kmeans_blocks(4096, 8, 16, tier=cost.TPU)
    back = jdse.PipelinePlan.from_json(plan.to_json())
    assert back.block == plan.block and back.depths == plan.depths
    _, tplan = dse.select_groupby_blocks(4096, 8, 4, tier=cost.TPU)
    # a plan read back from JSON is a cached one
    assert dse.TilePlan.from_json(
        jdse.TilePlan.from_json(tplan.to_json()).to_json()) \
        == dataclasses.replace(tplan, cached=True)


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


# ------------------------------------- the hand kernels' own plans (H100)
CSRC = Path(dse.__file__).resolve().parent.parent / "kernels" / "csrc"
PREFILL = (128, 256, 512, 1024, 2048, 4096, 8192)
DECODE = (256, 1024, 4096, 8192, 16384, 32768)


def _c_to_py(expr: str) -> str:
    expr = re.sub(r"(\w+) == (\d+) \? (\d+) : (\d+)",
                  r"(\3 if \1 == \2 else \4)", expr)
    return expr.replace("/", "//")


def _fa_cuh_bytes(which: str, tile_rows: int, d: int) -> int:
    """A block's shared bytes of ``flash_attention.cuh`` at head dim
    ``d``, evaluated from its text: ``WLayout<DP, NWG>::SMEM`` for
    wgmma (DP and NWG as ``launch_wgmma`` picks them), ``smem_floats``
    x 4 for FFMA (DP as ``launch_ffma``'s table picks it)."""
    text = (CSRC / "flash_attention.cuh").read_text()
    env = {n: int(v) for n, v in
           re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}
    env["TS"] = env["BR"] + 4
    if which == "wgmma":
        assert re.search(r"if \(d <= 64\)\s*return \(wide \? "
                         r"&launch_wgmma_dp<64, 2> : &launch_wgmma_dp<64, 1>",
                         text)
        env.update(DP=64 if d <= 64 else 128, NWG=tile_rows // 64)
        body = re.search(r"struct WLayout \{(.*?)\};", text, re.S).group(1)
        for name, expr in re.findall(
                r"static constexpr int (\w+) =\s*([^;]+);", body):
            env[name] = eval(_c_to_py(" ".join(expr.split())), {}, env)
        return env["SMEM"]
    expr = re.search(r"constexpr int smem_floats\(int dp\) \{\s*"
                     r"return ([^;]+);", text).group(1)
    assert "by_dp[(d + 15) / 16 - 1]" in text
    env["dp"] = -(-d // 16) * 16
    return 4 * eval(_c_to_py(expr), {}, env)


def _ssd_cuh_bytes(chunk: int) -> int:
    text = (CSRC / "ssd_scan.cuh").read_text()
    env = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        if "sizeof" in decl:          # per-type strides: not in the sum
            continue
        for part in decl.split(","):
            name, expr = part.split("=")
            env[name.strip()] = eval(_c_to_py(expr), {}, env)
    body = re.search(r"inline int smem_bytes\(int L\) \{\s*return "
                     r"([^;]+);", text).group(1)
    return eval(_c_to_py(body), {}, dict(env, L=chunk))


def test_attention_charge_twin_is_the_kernels():
    from repro_torch.core import codegen_cuda as cc
    for d in range(8, 129, 8):
        for tile in (64, 128):
            assert cc.fa_smem_bytes("wgmma", tile, d) \
                == _fa_cuh_bytes("wgmma", tile, d)
    for d in range(1, 129):
        assert cc.fa_smem_bytes("ffma", 64, d) == _fa_cuh_bytes("ffma", 64, d)
    assert cc.fa_smem_bytes("wgmma", 128, 128) == 132_152
    assert cc.fa_smem_bytes("ffma", 64, 128) == 119_808
    with pytest.raises(ValueError):
        cc.fa_smem_bytes("ffma", 128, 64)


def test_scan_charge_twin_is_the_kernels():
    from repro_torch.kernels.ssd_scan import layout
    for chunk in (1, 4, 16, 64, 128, 256, 1000, 4096, 14000):
        assert layout(chunk).smem_bytes == _ssd_cuh_bytes(chunk)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_plans_on_the_card_at_every_length(d, dtype):
    """Prefill (group 8: qwen2-72b's 64 query / 8 kv heads; and group 1)
    and decode (one query of each of a kv head's group) plan at every
    length, on a tile the kernel takes, charged its bytes."""
    from repro_torch.core import codegen_cuda as cc
    which = "wgmma" if dtype == "bfloat16" else "ffma"
    shapes = [(sq, sq, g) for sq in PREFILL for g in (1, 8)] \
        + [(1, sk, g) for sk in DECODE for g in (1, 8)]
    for sq, sk, group in shapes:
        blocks, plan = dse.select_attention_blocks(
            sq, sk, d, group, dtype, tier=cost.H100_SXM, cache=False)
        assert blocks[0] in cc.fa_tiles(which, group * sq)
        assert blocks[1] == cc.FA_BC
        assert plan.vmem_bytes == _fa_cuh_bytes(which, blocks[0], d) \
            <= H100_BUDGET
        if which == "wgmma" and group * sq > 64:
            assert blocks[0] == 128       # K and V read once per 128 rows


def test_attention_plan_defaults_and_raises():
    """Without a group or type the plan is float32's (the FFMA path) for
    one query head; a head dim past the kernels' raises as the reference
    raises where no candidate fits."""
    from repro_torch.core import codegen_cuda as cc
    blocks, plan = dse.select_attention_blocks(256, 256, 64,
                                               tier=cost.H100_SXM,
                                               cache=False)
    assert blocks == (64, 64)
    assert plan.vmem_bytes == cc.fa_smem_bytes("ffma", 64, 64)
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.select_attention_blocks(64, 64, 144, tier=cost.H100_SXM,
                                    cache=False)
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.select_attention_blocks(4096, 4096, 128, 8, "bfloat16",
                                    tier=cost.H100_SXM, cache=False,
                                    vmem_budget=100_000)


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("seq", [256, 512, 1024, 2048, 4096, 8192])
def test_scan_plans_on_the_card_at_every_length(n, seq):
    from repro_torch.kernels.ssd_scan import layout
    chunk, plan = dse.select_scan_blocks(seq, n, 64, tier=cost.H100_SXM,
                                         cache=False)
    assert seq % chunk == 0 and chunk % 4 == 0
    assert plan.vmem_bytes == layout(chunk).smem_bytes \
        == _ssd_cuh_bytes(chunk) <= H100_BUDGET


def test_scan_plan_raises_past_the_cards_chunk():
    """A prime sequence past ~14,000 steps has only itself as a chunk,
    whose cum, dt and w pass the card's shared memory: no plan."""
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.select_scan_blocks(16411, 64, 64, tier=cost.H100_SXM,
                               cache=False)
    chunk, _ = dse.select_scan_blocks(13999, 64, 64, tier=cost.H100_SXM,
                                      cache=False)
    assert chunk == 13999


def test_kernel_plans_are_priced_not_timed(monkeypatch):
    """``measure="top_k"`` on the card's tier keeps the kernel's priced
    plan and records a ``lower-unsupported`` fallback (the proxy is not
    the kernel), lowering nothing."""
    from repro_torch.core import codegen_cuda, resilience

    def _boom(*a, **k):
        raise AssertionError("lowered a proxy of a hand kernel")

    monkeypatch.setattr(codegen_cuda, "lower_for_timing", _boom)
    resilience.LOG.reset()
    got = dse.select_attention_blocks(1024, 1024, 128, 8, "bfloat16",
                                      tier=cost.H100_SXM, cache=False,
                                      measure="top_k", device="cpu")
    assert got[0] == dse.select_attention_blocks(
        1024, 1024, 128, 8, "bfloat16", tier=cost.H100_SXM,
        cache=False)[0]
    assert not got[1].measured
    assert any(e.kind == "lower-unsupported" and e.action == "fallback"
               for e in resilience.LOG.events())


# ------------------------------------- the tiled GEMM's own space on the card
GEMM_SHAPES = [(512, 512, 512), (4096, 4096, 4096), (2048, 1024, 768)]


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=str)
def test_card_gemm_plan_lowers_to_the_template(shape):
    """On the H100 tier ``lower_auto(gemm)`` plans in the template's own
    space: the tiled IR is the Table 3 form ``match_tiled_gemm`` takes,
    and the plan's charge is the shared bytes the launch allocates
    (``gemm_layout``, padding included)."""
    from repro_torch.core import codegen_cuda as cc
    from repro_torch.core.strip_mine import tile

    p = dse.gemm_program(*shape)
    call = cc.lower_auto(p, device="cpu", tier=cost.H100_SXM, cache=False)
    plan = call.tile_plan
    (bm, bn), (bk,) = plan.sizes["gemm"], plan.sizes["gemm_k"]
    assert cc.match_tiled_gemm(tile(p, plan.sizes,
                                    vmem_budget_words=H100_BUDGET // 4))
    assert plan.vmem_bytes == cc.gemm_layout(bm, bn, bk,
                                             plan.depth).smem_bytes
    assert plan.vmem_bytes <= H100_BUDGET and bk < shape[2]
    assert call.source == cc.gemm_source(bm, bn, bk, plan.depth)
    m, n, k = shape
    assert plan.traffic_words == m * k * (n // bn) + k * n * (m // bm) \
        + m * n
    if m == 512:        # the lowered call computes the product
        x = np.random.RandomState(0).randn(m, k).astype(np.float32)
        y = np.random.RandomState(1).randn(k, n).astype(np.float32)
        np.testing.assert_allclose(call(x=x, y=y).numpy(), x @ y,
                                   rtol=2e-3, atol=2e-3)


def test_card_gemm_space_is_the_templates():
    """Every candidate of the space is a tile the template takes at the
    extents, at every depth of ``DEPTHS``, charged ``gemm_layout``; the
    reference's tier keeps the reference's search."""
    from repro_torch.core import codegen_cuda as cc

    p = dse.gemm_program(2048, 1024, 768)
    kernel = dse.template_kernel(p, cost.H100_SXM)
    assert dse.template_kernel(p, cost.TPU) is None
    assert dse.template_kernel(dse.filter_reduce_program(4096),
                               cost.H100_SXM) is None
    assert kernel.depths == dse.DEPTHS and kernel.lowers
    for sizes in kernel.combos():
        (bm, bn), (bk,) = sizes["gemm"], sizes["gemm_k"]
        lay = cc.gemm_layout(bm, bn, bk, 2)
        assert 2048 % bm == 0 and 1024 % bn == 0 and 768 % bk == 0
        assert bm % lay.tm == 0 and bn % lay.tn == 0
        assert lay.threads <= dse.GEMM_MAX_THREADS and bk < 768
        for d in kernel.depths:
            assert kernel.charge(sizes, d) == cc.gemm_layout(
                bm, bn, bk, d).smem_bytes
    with pytest.raises(ValueError, match="takes no tile"):
        dse.explore(dse.gemm_program(250, 256, 256), tier=cost.H100_SXM,
                    kernel=dse.template_kernel(
                        dse.gemm_program(250, 256, 256), cost.H100_SXM),
                    cache=False)


def test_card_gemm_measured_winner_is_certified(tmp_path):
    """Measured mode in the template's space times the candidates (the
    CPU runs the plain version) and ships a winner certified by
    ``certify_gemm_plan`` -- no ``lower-unsupported`` fallback."""
    from repro_torch.core import resilience

    p = dse.gemm_program(256, 256, 256)
    resilience.LOG.reset()
    plan = dse.explore(p, tier=cost.H100_SXM, device="cpu",
                       kernel=dse.template_kernel(p, cost.H100_SXM),
                       measure="top_k", cache=str(tmp_path / "c.json"),
                       timing_db=str(tmp_path / "t.json"), repeat=1,
                       warmup=0)
    assert plan.measured and plan.timed >= 1
    assert not [e for e in resilience.LOG.events()
                if e.kind == "lower-unsupported"]
    ok, why = resilience.certify_gemm_plan(
        256, 256, 256, plan.sizes["gemm"] + plan.sizes["gemm_k"],
        depth=plan.depth, device="cpu")
    assert ok, why
