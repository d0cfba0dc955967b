"""Host-side parity of the PyTorch port (``repro_torch``) with the JAX
package (``repro``): IR structure after tiling and fusion, traffic words,
on-chip plans and the analytic pipeline DSE must match *exactly* under
the reference's TPU tier; the port's own H100 tier plans within the
card's budget; and the port's package boundary holds.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from repro.core import cost as jcost
from repro.core import dse as jdse
from repro.core import ir as jir
from repro.core import pipeline as jpl
from repro.core.strip_mine import tile as jtile
from repro.patterns import analytics as jan

from repro_torch.core import cost, dse, ir, pipeline as pl
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

NAMES = sorted(an.PIPELINES)
TPU = cost.TPU
ROOT = Path(__file__).resolve().parents[1]


def _pipes(name):
    return jan.PIPELINES[name]()[0], an.PIPELINES[name]()[0]


def _plan_fields(p):
    return (p.block, tuple(map(tuple, p.groups)), tuple(p.group_blocks),
            tuple(p.depths), p.traffic_words, p.unfused_traffic_words,
            p.vmem_bytes, p.modeled_seconds, p.explored, p.pruned)


def test_tpu_tier_is_the_reference_constants():
    assert (TPU.hbm_bytes_per_s, TPU.peak_flops, TPU.onchip_bytes,
            TPU.dma_latency_s) == (jcost.HBM_BYTES_PER_S, jcost.PEAK_FLOPS,
                                   jcost.VMEM_BYTES,
                                   jcost.DMA_ISSUE_LATENCY_S)


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("name", NAMES)
def test_traffic_and_memory_parity(name, block):
    jp, tp = _pipes(name)
    words = TPU.onchip_bytes // 4
    assert pl.fused_traffic_words(tp, block, vmem_budget_words=words) \
        == jpl.fused_traffic_words(jp, block)
    assert pl.unfused_traffic_words(tp) == jpl.unfused_traffic_words(jp)
    for depth in (2, 3, 4):
        assert pl.fused_memory_plan(
            tp, block, vmem_budget_bytes=TPU.onchip_bytes,
            depth=depth).total_bytes \
            == jpl.fused_memory_plan(jp, block, depth=depth).total_bytes


@pytest.mark.parametrize("name", NAMES)
def test_fused_ir_structure_parity(name):
    jp, tp = _pipes(name)
    jd, td = jpl.fuse_dag(jp, 128), pl.fuse_dag(tp, 128,
                                                vmem_budget_words=TPU.onchip_bytes // 4)
    assert [n for n, _ in td.terminals] == [n for n, _ in jd.terminals]
    for (_, a), (_, b) in zip(jd.terminals, td.terminals):
        assert ir.describe(b) == jir.describe(a)
        assert ir.signature(b) == jir.signature(a)
    assert td.refcounts == jd.refcounts


@pytest.mark.parametrize("vmem_budget", [None, 80_000])
@pytest.mark.parametrize("name", NAMES)
def test_explore_pipeline_parity(name, vmem_budget):
    jp, tp = _pipes(name)
    want = jdse.explore_pipeline(jp, vmem_budget=vmem_budget, cache=False)
    got = dse.explore_pipeline(tp, tier=TPU, vmem_budget=vmem_budget)
    assert _plan_fields(got) == _plan_fields(want)


def test_split_fallback_parity():
    """80 KB: the fully fused gda busts the budget; both packages split
    at the same cut with per-group blocks and depths."""
    got = dse.explore_pipeline(_pipes("gda")[1], tier=TPU, vmem_budget=80_000)
    assert not got.fused and got.groups == ((0, 1), (1, 2))
    assert got.traffic_words > dse.explore_pipeline(
        _pipes("gda")[1], tier=TPU).traffic_words


def test_baseline_traffic_words():
    with open(ROOT / "benchmarks" / "baseline_traffic.json") as f:
        base = json.load(f)["pipelines"]
    for name in NAMES:
        plan = dse.explore_pipeline(_pipes(name)[1], tier=TPU)
        assert plan.traffic_words == base[name]["fused"], name
        assert plan.unfused_traffic_words == base[name]["unfused"], name


def test_tiled_gemm_structure_and_traffic_parity():
    jp, jsizes, _, _ = jan.gemm()
    tp, tsizes, _, _ = an.gemm()
    assert tsizes == jsizes
    words = TPU.onchip_bytes // 4
    a, b = jtile(jp, jsizes), tile(tp, tsizes, vmem_budget_words=words)
    assert ir.describe(b) == jir.describe(a)
    assert cost.traffic(b).reads == jcost.traffic(a).reads
    assert cost.traffic(b).on_chip == jcost.traffic(a).on_chip


@pytest.mark.parametrize("name", NAMES)
def test_plan_json_crosses_packages(name):
    jp, tp = _pipes(name)
    want = jdse.explore_pipeline(jp, cache=False)
    got = dse.PipelinePlan.from_json(want.to_json())
    assert _plan_fields(got) == _plan_fields(want)
    assert dse.PipelinePlan.from_json(got.to_json()) == got


@pytest.mark.parametrize("name", NAMES)
def test_h100_plans_fit_the_card(name):
    """The port's own plans: fully fused for every pipeline at a full
    row count, within the H100's 227 KB per block."""
    n = 6_000_000 if name == "tpchq6" else 4_194_304
    pipe = an.PIPELINES[name](n=n)[0]
    plan = dse.explore_pipeline(pipe, tier=cost.H100_SXM)
    assert plan.fused
    assert plan.vmem_bytes <= cost.H100_SXM.onchip_bytes == 232_448
    assert pipe.shared_extent % plan.block == 0


def test_tuning_runtime_arguments_raise(tmp_path, monkeypatch):
    """Bucketing is taken as the reference takes it (a first call
    explores); measured mode runs on the card unless the caller names
    the CPU; a cache path is a tuning cache."""
    pipe = _pipes("tpchq6")[1]
    bucketed = dse.explore_pipeline(pipe, tier=TPU, bucketing=True,
                                    cache=str(tmp_path / "b.json"))
    assert not bucketed.warm_start and bucketed.block == \
        dse.explore_pipeline(pipe, tier=TPU, cache=False).block
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dse.explore_pipeline(pipe, tier=TPU, measure="top_k")
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.explore_pipeline(pipe, tier=TPU, vmem_budget=64)
    path = str(tmp_path / "x.json")
    plan = dse.explore_pipeline(pipe, tier=TPU, cache=path)
    assert dse.explore_pipeline(pipe, tier=TPU, cache=path).cached
    assert plan.block == dse.explore_pipeline(pipe, tier=TPU,
                                              cache=False).block


# ------------------------------------------------------------- boundary
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    port = ROOT / "src" / "repro_torch"
    covered = {p.relative_to(port).parts[0] for p in _port_files()[:-1]}
    assert {"models", "configs", "kernels", "core", "launch", "optim",
            "data", "checkpoint", "runtime"} <= covered
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro",
                                   "ml_dtypes"), (path, m)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    from repro_torch.core import codegen_cuda, codegen_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe, make_inputs, _ = an.PIPELINES["tpchq6"]()
    p, sizes, _, _ = an.gemm()
    outer, outer_sizes, _, _ = an.outerprod()
    for fn in (lambda: pl.lower_pipeline(pipe),
               lambda: pl.lower_pipeline(pipe, fused=False),
               lambda: pl.run_unfused(pipe, make_inputs()),
               lambda: codegen_torch.execute(p, {}),
               lambda: codegen_cuda.lower(tile(p, sizes)),
               lambda: codegen_cuda.lower(tile(outer, outer_sizes)),
               lambda: codegen_cuda.lower_auto(outer),
               lambda: dse.explore(outer),
               lambda: dse.explore_pipeline(pipe)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_cuda_body_survives_tiling():
    pipe = an.PIPELINES["kmeans"]()[0]
    fd = pl.fuse_dag(pipe, 128)
    for _, t in fd.terminals:
        assert t.inner.cuda and t.inner.cuda == pl.stage_map(pipe)[t.name].cuda
        for tc in t.loads:
            if isinstance(tc.src, ir.Pattern):
                assert tc.src.cuda == pl.stage_map(pipe)["km_assign"].cuda


def test_device_tier_off_the_card_is_the_default_target():
    assert cost.device_tier("cpu") == cost.DEFAULT_TIER == cost.H100_SXM
