"""The nearest-row path of the fused DAG (Lloyd's k-means with a centroid
table too large to stage whole): its ``DagSpec``, its plain version
against the benchmark's float64 reference at small sizes whose layout
(``memory.nearest_layout``'s rule) puts the table in several tiles, the
last one ragged, and the fold in several column slices, ties and
empty clusters, the DSE's plan on the card's tier, the generated
source, its counters; and the DAGs the path must leave as they were
(Q1, Q6, the small k-means DAG, gda): their CAM forms, specs and
sources, and the plans under ``cost.TPU`` equal to the JAX package's.
"""
import hashlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.patterns import analytics as jan

from repro_torch.core import codegen_cuda as cg
from repro_torch.core import cost, dse, memory, telemetry
from repro_torch.core import pipeline as pl
from repro_torch.patterns import analytics as an

ROOT = Path(__file__).resolve().parents[1]
SMEM = 232_448


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "_kmt_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROGRAM = _load("bench/programs/kmeans_lloyd.py")
REF = _load("bench/reference/kmeans_lloyd.py")


def _spec(n, k, d, block=256, depth=2):
    fd = pl.fuse_dag(PROGRAM.pipeline(n, k, d), block,
                     vmem_budget_words=SMEM // 4)
    return cg.dag_spec(fd.terminals, fd.grid, depth, smem_limit=SMEM)


# (n, k, d, block): at block 256 the rule's tile is 64 centroids, so 200
# span four tiles (the last of 8) and 200 columns two fold slices of 128
# and 72; at block 1024 the tile is 16, so 24 centroids span two tiles
SMALL = [(4096, 200, 200, 256), (4096, 24, 40, 1024)]


def _data(n, k, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, d, generator=g), torch.rand(k, d, generator=g)


def _judge(out, x, c):
    got = {name: v.numpy() for name, v in out.items()}
    return REF.errors(got, REF.answer({"points": x, "centroids": c}))


def test_small_spec_has_tiles_and_slices():
    spec = _spec(4096, 200, 200)
    lay = spec.nearest.layout
    assert (lay.tiles, lay.slices) == (4, 2)
    assert (lay.tile, lay.tm, lay.tn, lay.fold_cols) == (64, 8, 8, 128)
    assert lay.slab == 16 and lay.slabs == 13     # a zero-filled tail
    forms = {t.name: t.cam_form for t in spec.terminals}
    assert forms == {"km_counts": "shared", "km_sums": "sliced"}
    small = {t.name: t.cam_form
             for t in _spec(4096, 24, 40, block=1024).terminals}
    assert small == {"km_counts": "register", "km_sums": "sliced"}
    # the sums come last in the combine's output, after the counts
    views = {name: (a, b) for name, a, b, _ in cg._partial_views(spec)}
    assert views == {"km_counts": (0, 200),
                     "km_sums": (200, 200 + 200 * 200)}
    assert spec.nearest.partial1 == 200
    assert spec.onchip_bytes == lay.assign_bytes + 4 * 200
    assert spec.smem_bytes <= SMEM


@pytest.mark.parametrize("n,k,d,block", SMALL)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_the_reference(seed, n, k, d, block):
    x, c = _data(n, k, d, seed)
    spec = _spec(n, k, d, block)
    assert spec.nearest.layout.tiles >= 2
    out = cg.fused_dag_plain(spec, {"points": x, "centroids": c})
    numbers = _judge(out, x, c)
    assert numbers["counts_err"] == 0.0 and numbers["sums_err"] < 1e-6
    assert out["km_counts"].sum().item() == n


def test_lowered_callable_runs_the_plain_path_on_the_cpu():
    n, k, d = 4096, 200, 200
    x, c = _data(n, k, d, 2)
    fd = pl.fuse_dag(PROGRAM.pipeline(n, k, d), 256,
                     vmem_budget_words=SMEM // 4)
    call = cg.lower_fused_dag(fd.terminals, fd.grid, 2, device="cpu")
    out = call(points=x, centroids=c)
    plain = cg.fused_dag_plain(call.kernel.spec,
                               {"points": x, "centroids": c})
    assert all(torch.equal(out[name], plain[name]) for name in out)
    assert call.graphs is None          # no replay off the card


def test_exact_tie_goes_to_the_first_centroid_across_tiles():
    n, k, d = 4096, 200, 200
    x, _ = _data(n, k, d, 3)
    c = x[:k].clone()     # each centroid a point: none left empty by chance
    c[130] = c[2]         # the same row in tile 0 and tile 2 (of 64)
    c[5] = c[4]           # and twice in tile 0
    c[196] = 50.0         # a centroid no point is near, in the ragged tile
    spec = _spec(n, k, d)
    assert spec.nearest.layout.tiles == 4
    out = cg.fused_dag_plain(spec, {"points": x, "centroids": c})
    counts = out["km_counts"]
    assert counts[130] == 0 and counts[5] == 0
    assert counts[2] >= 2 and counts[4] >= 2
    assert counts[196] == 0 and torch.all(out["km_sums"][196] == 0)
    numbers = _judge(out, x, c)
    assert numbers == {"sums_err": pytest.approx(0.0, abs=1e-6),
                       "counts_err": 0.0}


def test_keys_are_first_minima_of_the_tiled_scores():
    """The plain version's assignment is the first minimum of the
    float32 scores whatever the tiling: one tile (block 64: tiles of
    256), four (block 256) or thirteen (block 1024) agree."""
    n, k, d = 4096, 200, 200
    x, c = _data(n, k, d, 4)
    c[90] = c[1]
    tiled = [_spec(n, k, d, block) for block in (64, 256, 1024)]
    assert [s.nearest.layout.tiles for s in tiled] == [1, 4, 13]
    outs = [cg.fused_dag_plain(s, {"points": x, "centroids": c})
            for s in tiled]
    assert all(torch.equal(outs[0]["km_counts"], o["km_counts"])
               for o in outs[1:])
    assert outs[0]["km_counts"][90] == 0


def test_layout_rule_at_the_source_shape():
    lay = memory.nearest_layout(128, 2, 256, 784, True, SMEM)
    assert (lay.tile, lay.tm, lay.tn, lay.tiles) == (128, 8, 8, 2)
    # 56 dimensions a slot (784 = 14 x 56), rows of 60 words: 15 pieces
    assert (lay.slab, lay.pad, lay.slabs) == (56, 4, 14)
    assert (lay.fold_cols, lay.slices, lay.fold_depth) == (128, 7, 3)
    assert lay.assign_bytes == 4 * (2 * 256 * 60 + 256 + 128)
    # the slab that divides the width, else 16 and a zero-filled tail
    assert memory.nearest_layout(128, 2, 24, 40, True, SMEM).slab == 16
    assert memory.nearest_layout(128, 2, 24, 28, True, SMEM).pad == 8
    assert lay.fold_bytes == 4 * (256 * 128 + 3 * 64 * 129) <= SMEM
    # no 8 x 8 block for 4096 rows a step; a table wider than a block
    assert memory.nearest_layout(4096, 2, 256, 784, True, SMEM) is None
    assert memory.nearest_layout(128, 2, 4096, 784, True, SMEM) is None
    assert memory.nearest_layout(128, 2, 256, 786, True, SMEM) is None


def test_dse_plans_the_source_shape_on_the_card_tier():
    pipe = PROGRAM.pipeline(8_099_840, 256, 784)
    plan = dse.explore_pipeline(pipe, tier=cost.H100_SXM, cache=False)
    assert plan.fused and plan.block == 128
    assert plan.vmem_bytes <= cost.H100_SXM.onchip_bytes
    # FFMA-bound: the modeled time is the distance loop's
    assert plan.modeled_seconds == pytest.approx(
        2 * 8_099_840 * 256 * 784 / cost.H100_SXM.peak_flops, rel=1e-9)
    fd = pl.fuse_dag(pipe, plan.block, vmem_budget_words=SMEM // 4)
    spec = cg.dag_spec(fd.terminals, fd.grid, plan.depths[0],
                       smem_limit=SMEM)
    assert spec.nearest.layout.tiles == 2 and spec.smem_bytes <= SMEM


def test_source_names_its_kernels_and_takes_no_atomics():
    spec = _spec(8192, 256, 784, block=128, depth=3)
    src = cg.nearest_source(spec)
    for name in ("nearest_assign_kernel", "nearest_fold_kernel",
                 "fdag_fold", "fdag_graph", "fdag_combine",
                 "ndag::Assign<BLOCK, 128, 8, 8, DEPTH, 256, 784, 56, 4>"):
        assert name in src
    here = ROOT / "src/repro_torch/kernels/csrc/nearest_dag.cuh"
    text = here.read_text()
    for code in (src, text):
        assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", code)
    assert "cp_async" in text
    assert cg.DagKernel(spec).source == src


def test_cam_form_counters_at_lowering():
    telemetry.reset()
    n, k, d = 4096, 24, 40
    fd = pl.fuse_dag(PROGRAM.pipeline(n, k, d), 256,
                     vmem_budget_words=SMEM // 4)
    cg.lower_fused_dag(fd.terminals, fd.grid, 2, device="cpu")
    got = telemetry.metrics_snapshot()["counters"]
    assert got["fused_dag.cam_form.sliced"] == 1
    assert got["fused_dag.cam_form.register"] == 1
    telemetry.reset()


def test_other_shapes_refused():
    # a table whose rows are not 16-byte multiples
    with pytest.raises(NotImplementedError, match="no tile layout"):
        _spec(4096, 24, 42)


# ----------------------------------------- what the path leaves unchanged
def _bench_program(name, rows):
    return _load(f"bench/programs/{name}.py").pipeline(rows)


UNCHANGED = [
    ("tpch_q6", lambda: _bench_program("tpch_q6", 1 << 16), 512, 3,
     [("q6_sum", "", 0)], 30720, "b97a2cf28ae86a1c"),
    ("tpch_q1", lambda: _bench_program("tpch_q1", 1 << 16), 512, 2,
     [("q1_groups", "register", 1)], 53392, "473ed10106416ab4"),
    ("kmeans", lambda: an.kmeans_pipeline(4096, 8, 16)[0], 128, 2,
     [("km_counts", "register", 1), ("km_sums", "register", 4)], 23584,
     "a8baeffa21568d38"),
    ("gda", lambda: an.PIPELINES["gda"]()[0], 64, 2,
     [("gda_scatter", "register", 8)], 51840, "21c766701e18e109"),
]


@pytest.mark.parametrize("name,make,block,depth,forms,smem,digest",
                         UNCHANGED, ids=[u[0] for u in UNCHANGED])
def test_row_staged_dags_unchanged(name, make, block, depth, forms, smem,
                                   digest):
    fd = pl.fuse_dag(make(), block, vmem_budget_words=SMEM // 4)
    spec = cg.dag_spec(fd.terminals, fd.grid, depth, smem_limit=SMEM)
    assert spec.nearest is None
    assert [(t.name, t.cam_form, t.cam_lanes)
            for t in spec.terminals] == forms
    assert spec.smem_bytes == smem
    src = cg.dag_source(spec)
    assert hashlib.sha256(src.encode()).hexdigest()[:16] == digest


def test_cam_forms_unchanged():
    assert cg.cam_forms([(6, 6)]) == [("register", 1)]
    assert cg.cam_forms([(256, 784), (256, 1)]) == [("shared", 32),
                                                    ("shared", 32)]
    assert cg.cam_forms([(8, 16), (8, 1)]) == [("register", 4),
                                               ("register", 1)]


def _fields(p):
    return (p.block, tuple(map(tuple, p.groups)), tuple(p.group_blocks),
            tuple(p.depths), p.traffic_words, p.unfused_traffic_words,
            p.vmem_bytes, p.modeled_seconds, p.explored, p.pruned)


@pytest.mark.parametrize("name", ["kmeans", "gda", "tpchq6"])
def test_tpu_plans_equal_the_jax_packages(name):
    jp, tp = jan.PIPELINES[name]()[0], an.PIPELINES[name]()[0]
    want = jdse.explore_pipeline(jp, cache=False)
    got = dse.explore_pipeline(tp, tier=cost.TPU, cache=False)
    assert _fields(got) == _fields(want)


def test_nearest_dag_has_no_tpu_template():
    """Under ``cost.TPU`` no candidate of the nearest-row DAG is fused
    (no template takes it there): the plans of the TPU tier stay the
    reference's, which has no such stage."""
    pipe = PROGRAM.pipeline(8192, 256, 784)
    fd = pl.fuse_dag(pipe, 128, vmem_budget_words=cost.TPU.onchip_bytes // 4)
    counters = {"explored": 0, "pruned": 0}
    assert dse._price_pipeline_group(
        pipe, 128, vmem_budget=cost.TPU.onchip_bytes, tier=cost.TPU,
        counters=counters) is None
    assert memory.nearest_dag(fd.patterns) == (256, 784, True)
    assert np.isfinite(counters["pruned"]) and counters["pruned"] == 1
