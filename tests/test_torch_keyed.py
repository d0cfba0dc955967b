"""The keyed hand kernels' host side on the CPU: ``fused_kmeans`` and
``groupby_fold`` generate one CUDA translation unit per shape, plan and
form (``source``), pick their forms and shared layouts by rules
(``kmeans_lanes`` / ``layout``, ``table_form`` / ``shared_bytes``) that
these tests hold at chip_smoke's plans for the card, and their plain
versions agree with the JAX package's Pallas kernels (interpret mode)
on the same seeded inputs: sums at 1e-4 / 1e-5 as in
``test_torch_kernels.py``, counts exactly.  The kernels themselves run
only on a GPU (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
from pathlib import Path

import numpy as np
import pytest

from repro.kernels.fused_kmeans import fused_kmeans_step as jfused_kmeans
from repro.kernels.groupby_fold import groupby_fold as jgroupby_fold

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, dse
from repro_torch.kernels import fused_kmeans as fkm
from repro_torch.kernels import groupby_fold as gbf

CARD_BYTES = 232_448          # the H100's opt-in shared memory per block
ROWS = 4_194_304              # chip_smoke's rows
CSRC = Path(fkm.__file__).resolve().parent / "csrc"


def _chip_kmeans_plan():
    block, plan = dse.select_fused_kmeans_blocks(ROWS, 8, 16,
                                                 tier=cost.H100_SXM)
    return block, plan.depth


def _chip_groupby_block(k, ew):
    return dse.select_groupby_blocks(ROWS, k, ew, tier=cost.H100_SXM)[0]


# ------------------------------------------------------------ fused_kmeans
def test_kmeans_layout_at_chip_smokes_plan():
    """1024 points a step, depth 3: the sums at one column slot (no
    exchange), the ring unpadded, one block per SM within the card."""
    assert _chip_kmeans_plan() == (1024, 3)
    lay = fkm.layout(8, 16, 1024, 3)
    assert lay == fkm.Layout(lanes=1, vec=True, ring_bytes=196_608,
                             stage_bytes=0, smem_bytes=197_664)
    other = fkm.layout(8, 16, 1024, 3,
                       cc.cam_forms([(8, 16), (8, 1)])[0][1])
    assert other.lanes == 4 and other.stage_bytes == 5_120
    assert lay.smem_bytes < other.smem_bytes <= CARD_BYTES


@pytest.mark.parametrize("k,d,lanes", [(8, 16, 1), (5, 3, 1), (8, 64, 8),
                                       (72, 16, 16), (32, 16, 8)])
def test_kmeans_lanes_fit_the_register_budget(k, d, lanes):
    assert fkm.kmeans_lanes(k, d) == lanes
    assert k * -(-d // lanes) + k + d <= fkm.KM_REG_WORDS
    if lanes > 1:
        half = lanes // 2
        assert k * -(-d // half) + k + d > fkm.KM_REG_WORDS


def test_kmeans_refuses_centroids_beyond_the_registers():
    with pytest.raises(ValueError, match="registers"):
        fkm.kmeans_lanes(100, 16)
    with pytest.raises(ValueError, match="lanes"):
        fkm.layout(8, 16, 1024, 3, lanes=3)


@pytest.mark.parametrize("d", range(4, 132, 4))
def test_kmeans_swizzle_spreads_a_quarter_warp_over_all_bank_groups(d):
    """Eight lanes reading chunk q of eight consecutive rows (a quarter
    of a warp's LDS.128) hit eight distinct 16-byte bank groups, and the
    swizzle keeps each row's chunks inside the row."""
    c = d // 4
    for r0 in range(0, 64, 8):
        for q in range(c):
            phys = [r * c + (q ^ fkm.swizzle(d, r)) for r in range(r0, r0 + 8)]
            assert len({p % 8 for p in phys}) == 8, (d, r0, q)
            assert all(r * c <= p < (r + 1) * c
                       for r, p in zip(range(r0, r0 + 8), phys))


@pytest.mark.parametrize("k,d,block,depth,lanes", [(8, 16, 1024, 3, 1),
                                                   (8, 16, 1024, 3, 4),
                                                   (5, 3, 200, 2, 1)])
def test_kmeans_source_names_its_accumulators(k, d, block, depth, lanes):
    src = fkm.source(k, d, block, depth, lanes)
    assert src == fkm.source(k, d, block, depth, lanes)
    assert "atomic" not in src and "cam_add" not in src
    assert f"fkm::kmeans_kernel<{k}, {d}, {block}, {depth}, Cam>" in src
    pieces = -(-d // lanes)
    for j in range(k):
        assert f"cnt_{j}_0 = 0.0f" in src
        for p in range(pieces):
            assert f"sum_{j}_{p} = 0.0f" in src
    assert f"sum_0_{pieces}" not in src and "float acc[" not in src
    assert ("stage_w[" in src) == (lanes > 1)
    assert f"STAGE_WORDS = {cc.piece_words(lanes)};" in src


def test_kmeans_template_streams_by_a_cp_async_ring():
    text = (CSRC / "fused_kmeans.cuh").read_text()
    assert "atomic" not in text
    assert "hop::cp_async<16>" in text and "hop::cp_async<4>" in text
    assert "hop::cp_async_wait<DEPTH - 2>();" in text
    assert "__fmul_rn" in text and "__fadd_rn" in text


def test_kmeans_plain_version_matches_the_reference_counts_exactly():
    n, k, d = 4096, 8, 16
    rng = np.random.RandomState(5)
    pts = rng.randn(n, d).astype(np.float32)
    cents = rng.randn(k, d).astype(np.float32)
    cents[k - 1] = cents[2]                  # a tie: the lower index wins
    js, jc = jfused_kmeans(pts, cents, block_n=1024)
    sums, counts = fkm.fused_kmeans_step(pts, cents, block_n=1024, depth=3,
                                         device="cpu")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts[k - 1] == 0
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)


def test_kmeans_refuses_a_ring_of_one_slot():
    pts = np.zeros((64, 4), np.float32)
    with pytest.raises(ValueError, match="depth"):
        fkm.fused_kmeans_step(pts, pts[:2], block_n=16, depth=1,
                              device="cpu")


# ------------------------------------------------------------ groupby_fold
@pytest.mark.parametrize("k,ew,block,form,bytes_", [
    (64, 8, 2048, ("shared", 4), 66_560),
    (8, 1, 8192, ("register", 1), 0)])
def test_groupby_form_at_chip_smokes_plans(k, ew, block, form, bytes_):
    assert _chip_groupby_block(k, ew) == block
    _, plan = dse.select_groupby_blocks(ROWS, k, ew, tier=cost.H100_SXM)
    assert plan.depth == 3
    assert gbf.table_form(k, ew, CARD_BYTES) == form
    if form[0] == "shared":
        assert gbf.shared_bytes(k, ew, form[1]) == bytes_ <= CARD_BYTES


@pytest.mark.parametrize("k,ew,form", [
    (8, 1, ("register", 1)), (16, 4, ("register", 1)),
    (40, 1, ("register", 1)), (64, 1, ("shared", 32)),
    (41, 1, ("shared", 32)), (65, 1, ("shared", 32)),
    (64, 8, ("shared", 4)), (16, 5, ("shared", 4)), (3, 80, ("shared", 1)),
    (1024, 1, ("shared", 4)), (256, 8, ("shared", 2))])
def test_groupby_form_rule(k, ew, form):
    """Register accumulators while K x E fits 64 words a lane and the
    K (E + 1) instructions a row stay within ISSUE_PER_BYTE per byte
    (K <= 40); else per-(warp, group) shared tables, the groups halved
    until the tables fit."""
    assert gbf.table_form(k, ew, CARD_BYTES) == form
    if form[0] == "shared":
        assert gbf.shared_bytes(k, ew, form[1]) <= CARD_BYTES
        if form[1] < 32 // max(1, 1 << (max(ew, 1) - 1).bit_length()):
            assert gbf.shared_bytes(k, ew, 2 * form[1]) > CARD_BYTES


def test_groupby_refuses_a_table_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        gbf.table_form(1024, 64, CARD_BYTES)


@pytest.mark.parametrize("k,ew,block,form,groups", [
    (64, 8, 2048, "shared", 4), (8, 1, 8192, "register", 1),
    (16, 4, 128, "register", 1), (3, 80, 64, "shared", 1)])
def test_groupby_source(k, ew, block, form, groups):
    src = gbf.source(k, ew, block, form, groups)
    assert src == gbf.source(k, ew, block, form, groups)
    assert "atomic" not in src and "cam_add" not in src
    if form == "register":
        assert f"gbf::register_kernel<{k}, {ew}, {block}, Cam>" in src
        assert all(f"acc_{j}_{c} = 0.0f" in src
                   for j in range(k) for c in range(ew))
        assert "float acc[" not in src
    else:
        assert f"gbf::shared_kernel<{k}, {ew}, {block}, {groups}>" in src
        assert "struct Cam" not in src


def test_keyed_templates_take_no_atomics():
    for name in ("groupby_fold.cuh", "fused_kmeans.cuh"):
        assert "atomic" not in (CSRC / name).read_text()
    assert "cam_add" not in (CSRC / "fused_dag.cuh").read_text()


@pytest.mark.parametrize("t,k,ew,bt", [(8192, 64, 8, 2048),
                                       (8192, 8, 1, 8192),
                                       (4096, 3, 80, 1024)])
def test_groupby_plain_version_matches_jax_at_each_form(t, k, ew, bt):
    rng = np.random.RandomState(k + ew)
    keys = rng.randint(-1, k + 1, t).astype(np.int32)
    vals = rng.randn(t, ew).astype(np.float32)
    want = jgroupby_fold(keys, vals, k, block_t=bt)
    got = gbf.groupby_fold(keys, vals, k, block_t=bt, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
