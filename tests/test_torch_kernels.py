"""The port's hand-written kernel layer (``repro_torch.kernels``: ``matmul``,
``filter_reduce``, ``fused_filter_fold``, ``groupby_fold``,
``fused_kmeans``, ``ops``, ``ref``, ``autotile``) on the CPU -- each
kernel's plain version -- against the JAX package's Pallas kernels in
interpret mode and its ``ref`` oracles, on the same seeded numpy inputs.
The cases mirror ``tests/test_kernels.py`` and the kernel tests of
``tests/test_pipeline.py``, with the reference tests' tolerances:
matmul float32 2e-5 and bfloat16 2e-2 (with the rule that picks its
wgmma or FFMA kernel on the card), groupby 1e-5, filters 1e-4,
kmeans sums 1e-4 and counts exact.  ``auto_tile`` plans differ between
the packages (the reference plans for its TPU budget, the port for the
card's), so those cases compare values only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotile as jautotile
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.filter_reduce import filter_reduce as jfilter_reduce
from repro.kernels.fused_filter_fold import \
    fused_filter_fold as jfused_filter_fold
from repro.kernels.fused_kmeans import fused_kmeans_step as jfused_kmeans
from repro.kernels.groupby_fold import groupby_fold as jgroupby_fold
from repro.kernels.matmul import matmul as jmatmul

from repro_torch.core import cost
from repro_torch.kernels import autotile, build, ops, ref
from repro_torch.kernels import filter_reduce as fr
from repro_torch.kernels import grid_flags as gf
from repro_torch.kernels.filter_reduce import filter_reduce
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_filter_fold import fused_filter_fold
from repro_torch.kernels.fused_kmeans import fused_kmeans_step
from repro_torch.kernels.groupby_fold import groupby_fold
from repro_torch.kernels import matmul as mm
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.ssd_scan import ssd_scan


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _keys(seed, t, lo, hi):
    return np.random.RandomState(seed).randint(lo, hi, t).astype(np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ------------------------------------------------------------- matmul
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 128, 64, 128, 64, 64),
    (64, 256, 128, 32, 128, 128),
    (8, 16, 8, 8, 8, 16),
])
def test_matmul_shapes_match_jax(m, k, n, bm, bn, bk):
    x, y = _r(0, m, k), _r(1, k, n)
    want = jmatmul(x, y, block_m=bm, block_n=bn, block_k=bk)
    got = matmul(x, y, block_m=bm, block_n=bn, block_k=bk, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_dtypes_match_jax(dtype):
    x, y = _r(2, 64, 64), _r(3, 64, 64)
    want = jmatmul(jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                   block_m=32, block_n=32, block_k=32)
    tdt = getattr(torch, dtype)
    got = matmul(torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt),
                 block_m=32, block_n=32, block_k=32, device="cpu")
    assert got.dtype == tdt      # out_dtype defaults to x.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.matmul(jnp.asarray(x, dtype),
                                         jnp.asarray(y, dtype))),
        rtol=tol, atol=tol)


def test_matmul_auto_tile_matches_jax():
    x, y = _r(0, 256, 128), _r(1, 128, 256)
    want = jmatmul(x, y, auto_tile=True)
    got = matmul(x, y, auto_tile=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(autotile.tuned_matmul(x, y, device="cpu"),
                               got.numpy(), rtol=0, atol=0)


def test_matmul_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="must divide"):
        matmul(x, x, block_m=48, device="cpu")
    with pytest.raises(ValueError, match="floating-point"):
        matmul(x.int(), x.int(), device="cpu")
    with pytest.raises(ValueError, match="floating-point"):
        matmul(x, x.bool(), device="cpu")
    with pytest.raises(ValueError, match="matmul of"):
        matmul(x, torch.zeros(32, 8), device="cpu")


# the reference's kernels multiply, fold and sum whatever floating types
# they are given in float32; the port's wrappers cast the same way and
# return the reference's type (x's for matmul, float32 for the folds)
@pytest.mark.parametrize("xt,yt", [("float16", "float16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_matmul_takes_the_reference_kernels_input_types(xt, yt):
    x, y = _r(6, 64, 64), _r(7, 64, 64)
    want = jmatmul(jnp.asarray(x, xt), jnp.asarray(y, yt), block_m=32,
                   block_n=32, block_k=32)
    got = matmul(torch.as_tensor(x).to(getattr(torch, xt)),
                 torch.as_tensor(y).to(getattr(torch, yt)), block_m=32,
                 block_n=32, block_k=32, device="cpu")
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = 2e-3 if "bfloat16" not in (xt, want.dtype) else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# which kernel each input takes on the card: bfloat16 pairs whose rows are
# whole 16-byte pieces run wgmma, everything else FFMA, 16 bytes a copy
# when its float32 rows allow
@pytest.mark.parametrize("xt,yt,k,n,which,vec", [
    ("bfloat16", "bfloat16", 4096, 4096, "wgmma", 4),
    ("bfloat16", "bfloat16", 136, 72, "wgmma", 4),
    ("bfloat16", "bfloat16", 60, 40, "ffma", 4),
    ("bfloat16", "bfloat16", 64, 36, "ffma", 4),
    ("bfloat16", "bfloat16", 64, 30, "ffma", 1),
    ("float32", "float32", 4096, 4096, "ffma", 4),
    ("float32", "float32", 63, 64, "ffma", 1),
    ("bfloat16", "float32", 64, 64, "ffma", 4),
    ("float16", "float16", 64, 64, "ffma", 4),
])
def test_matmul_dispatch_rule(xt, yt, k, n, which, vec):
    assert mm.variant(getattr(torch, xt), getattr(torch, yt), k, n) == which
    assert mm.ffma_vec(k, n) == vec


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_view_off_a_16_byte_boundary_is_copied(dtype):
    """What ``matmul`` and ``flash_attention`` do to such a view before
    TMA or 16-byte ``cp.async`` reads it."""
    view = torch.arange(65, dtype=dtype)[1:].view(8, 8)
    assert view.data_ptr() % 16
    copy = build.aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    assert build.aligned(copy) is copy


# shapes whose m and n are not multiples of the kernels' 128 x 128 tile,
# k that is (wgmma) and is not (ffma) a multiple of 8
@pytest.mark.parametrize("m,k,n", [(200, 136, 72), (96, 60, 40),
                                   (8, 16, 8)])
def test_matmul_ragged_bfloat16_matches_jax(m, k, n):
    x, y = _r(8, m, k), _r(9, k, n)
    want = jmatmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                   block_m=m, block_n=n, block_k=k)
    got = matmul(torch.as_tensor(x).bfloat16(), torch.as_tensor(y).bfloat16(),
                 block_m=m, block_n=n, block_k=k, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------------- groupby fold
def _blocks(name, block):
    """A block argument, or ``auto_tile`` when ``block`` is None."""
    return {"auto_tile": True} if block is None else {name: block}


@pytest.mark.parametrize("t,k,ew,bt", [(512, 16, 4, 128), (256, 8, 1, 256),
                                       (128, 64, 8, 32), (512, 16, 4, None)])
def test_groupby_fold_matches_jax(t, k, ew, bt):
    keys, vals = _keys(0, t, 0, k), _r(1, t, ew)
    want = jgroupby_fold(keys, vals, k, **_blocks("block_t", bt))
    got = groupby_fold(keys, vals, k, device="cpu", **_blocks("block_t", bt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jref.groupby_fold(keys, vals, k),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("auto_tile", [False, True])
def test_groupby_fold_1d_values_match_jax(auto_tile):
    keys, vals = _keys(2, 512, 0, 16), _r(3, 512)
    kw = {"auto_tile": True} if auto_tile else {}
    want = jgroupby_fold(keys, vals, 16, **kw)
    got = groupby_fold(keys, vals, 16, device="cpu", **kw)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_groupby_fold_drops_keys_outside_the_table():
    keys = np.array([0, 1, -1, 8, 3, 9, 2, 7], np.int32)
    ones = np.ones(8, np.float32)
    want = [1, 1, 1, 1, 0, 0, 0, 1]
    np.testing.assert_array_equal(jgroupby_fold(keys, ones, 8, block_t=4),
                                  want)
    for got in (groupby_fold(keys, ones, 8, block_t=4, device="cpu"),
                ops.groupby(keys, ones, 8, device="cpu"),
                ops.groupby(keys, ones, 8, use_kernel=False, device="cpu"),
                ref.groupby_fold(torch.as_tensor(keys),
                                 torch.as_tensor(ones), 8)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_groupby_fold_refuses_what_the_kernel_does_not_take():
    keys = np.zeros(64, np.int32)
    with pytest.raises(ValueError, match="integers"):
        groupby_fold(keys.astype(np.float32), np.ones(64, np.float32), 4,
                     device="cpu")
    with pytest.raises(ValueError, match="floating point"):
        groupby_fold(keys, np.ones(64, np.int32), 4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        groupby_fold(keys, np.ones(64, np.float32), 4, block_t=48,
                     device="cpu")


@pytest.mark.parametrize("kt,vt", [(np.int64, np.float32),
                                   (np.int32, np.float16),
                                   (np.int64, np.float16)])
def test_groupby_fold_takes_the_reference_kernels_input_types(kt, vt):
    """int64 keys (torch's index type) are cast to int32, as
    ``moe.router_counts`` casts them; float16 values are summed in
    float32; the result is float32, as the reference's."""
    keys, vals = _keys(8, 512, -2, 18).astype(kt), _r(9, 512, 4).astype(vt)
    want = jgroupby_fold(keys.astype(np.int32), vals, 16, block_t=128)
    for got in (groupby_fold(keys, vals, 16, block_t=128, device="cpu"),
                ops.groupby(torch.as_tensor(keys), torch.as_tensor(vals), 16,
                            block_t=128, device="cpu")):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ filter kernels
FILTERS = {"filter_reduce": (jfilter_reduce, filter_reduce),
           "fused_filter_fold": (jfused_filter_fold, fused_filter_fold)}


@pytest.mark.parametrize("t,bt", [(2048, 512), (1024, 1024), (512, 128),
                                  (2048, None)])
def test_filter_reduce_matches_jax(t, bt):
    x, w = _r(0, t), _r(1, t)
    want = jfilter_reduce(x, w, -0.5, 0.8, **_blocks("block_t", bt))
    got = filter_reduce(x, w, -0.5, 0.8, device="cpu",
                        **_blocks("block_t", bt))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(got), float(jref.filter_reduce(x, jnp.float32(-0.5),
                                             jnp.float32(0.8), w)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("auto_tile", [False, True])
def test_filter_kernels_match_jax(name, auto_tile):
    """test_pipeline.py's fused_filter_fold case, for both kernels."""
    jfn, fn = FILTERS[name]
    rng = np.random.RandomState(0)
    x, w = rng.rand(2048).astype(np.float32), rng.rand(2048).astype(np.float32)
    kw = {"auto_tile": True} if auto_tile else {"block_t": 256}
    want = np.sum(np.where((x >= 0.1) & (x < 0.9), x * w, 0.0))
    got = fn(x, w, 0.1, 0.9, device="cpu", **kw)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jfn(x, w, 0.1, 0.9, **kw)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_bounds_are_float32(name):
    """``float32(0.7)`` and ``float32(0.9)`` lie below 0.7 and 0.9: the
    row equal to float32(lo) is kept and the one equal to float32(hi)
    dropped, as the reference's float32 bounds do (a float64 comparison
    would do the opposite for both)."""
    jfn, fn = FILTERS[name]
    x = np.array([0.7, 0.9, 0.8, 0.1], np.float32)
    w = np.array([1.0, 10.0, 100.0, 1000.0], np.float32)
    want = float(jfn(x, w, 0.7, 0.9, block_t=4))
    got = fn(x, w, 0.7, 0.9, block_t=4, device="cpu")
    assert float(got) == want == np.float32(0.7) * 1.0 + np.float32(0.8) * 100
    assert float(ops.filter_sum(x, w, 0.7, 0.9, use_kernel=False,
                                device="cpu")) == want


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_where_fails_adds_zero_even_for_nan(name):
    jfn, fn = FILTERS[name]
    x = np.array([0.5, 2.0, np.inf, 0.25], np.float32)
    w = np.array([2.0, np.nan, 0.0, 4.0], np.float32)
    want = float(jfn(x, w, 0.0, 1.0, block_t=2))
    got = float(fn(x, w, 0.0, 1.0, block_t=2, device="cpu"))
    assert got == want == 2.0


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_kernels_take_the_reference_kernels_input_types(name):
    """float16 rows are read as float32, as the reference's kernels read
    them; the sum is float32."""
    jfn, fn = FILTERS[name]
    x, w = _r(10, 1024).astype(np.float16), _r(11, 1024).astype(np.float16)
    want = jfn(x, w, -0.5, 0.8, block_t=256)
    got = fn(x, w, -0.5, 0.8, block_t=256, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-4)


# ------------------- the filter-folds' ring and the flag words (host side)
CARD_OPTIN = cost.H100_SXM.onchip_bytes      # 232,448 B a block


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("depth", fr.DEPTHS)
@pytest.mark.parametrize("block_t", [1, 3, 4, 1000, 1365, 9600, 40_000,
                                     40_001, 65_537, 1 << 18])
def test_ring_form_covers_any_step(block_t, depth, staged):
    """``ring_form`` for any block_t the wrappers take: a whole step a
    slot when the ring fits the card's block, else fixed pieces (whole
    float4 rounds) that cover the step; a slot holds any unit at its
    source alignment; the staged kernel refuses a stage of block_t floats
    beyond a block's shared memory."""
    if staged and 4 * block_t > CARD_OPTIN:
        with pytest.raises(ValueError, match="shared memory"):
            fr.ring_form(block_t, depth, staged, CARD_OPTIN)
        return
    form = fr.ring_form(block_t, depth, staged, CARD_OPTIN)
    assert (form.block_t, form.depth, form.staged) == (block_t, depth, staged)
    assert form.arrays == (3 if staged else 2)
    assert form.variant == 2 * depth + staged
    assert form.ring_bytes == 4 * form.arrays * depth * form.slot_words
    assert form.smem_bytes == max(form.ring_bytes, 4 * fr.COMBINE_WORDS)
    assert form.smem_bytes <= CARD_OPTIN
    whole = 4 * form.arrays * depth * fr.slot_words(block_t, block_t)
    if whole <= CARD_OPTIN:
        assert (form.piece, form.pieces) == (block_t, 1)
    else:
        assert form.piece % fr.PIECE_ALIGN == 0 and form.piece < block_t
        bigger = fr.slot_words(block_t, form.piece + fr.PIECE_ALIGN)
        assert 4 * form.arrays * depth * bigger > CARD_OPTIN
    units = [min(form.piece, block_t - j * form.piece)
             for j in range(form.pieces)]
    assert sum(units) == block_t and min(units) > 0
    assert form.slot_words % 4 == 0
    for first in range(4):     # a unit's first row, mod 4
        if block_t % 4 == 0 and first:
            continue           # steps and pieces start on 16 bytes
        assert first + max(units) <= form.slot_words
    if block_t % 4 == 0:
        assert form.slot_words == form.piece


@pytest.mark.parametrize("kind,staged", [("filter_reduce", False),
                                         ("fused_filter_fold", True)])
@pytest.mark.parametrize("tier", [cost.TPU, cost.H100_SXM], ids=str)
def test_ring_form_takes_the_plans_bytes(kind, staged, tier):
    """At TPC-H Q6's 6,000,000 rows the ring is the plan's block at its
    depth, and its bytes are the plan's charge (x and w, and the staged
    kernel's intermediate, at depth slots): on the card's budget (9600
    rows at depth 3, and at depth 2 with the stage; 230,400 B) and on
    the reference's (80,000 rows at depth 4)."""
    block, plan = ops.resolve_plan(kind, 6_000_000, tier=tier)
    form = fr.ring_form(block, plan.depth, staged, tier.onchip_bytes)
    assert (form.piece, form.pieces) == (block, 1)
    assert form.ring_bytes == plan.vmem_bytes
    if tier is cost.H100_SXM:
        assert (block, plan.depth, form.smem_bytes) == (
            9600, 2 if staged else 3, 230_400)


def test_ring_form_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="depth"):
        fr.ring_form(1024, 5, False, CARD_OPTIN)
    with pytest.raises(ValueError, match="positive"):
        fr.ring_form(0, 2, False, CARD_OPTIN)
    with pytest.raises(ValueError, match="no ring"):
        fr.ring_form(1 << 16, 4, False, 16 * 1024)


def test_flag_words_layout():
    """A flag word: the epoch above a 2-bit state in the high half, the
    value (an int count or a float's bits) in the low half."""
    w = gf.word(5, gf.INCLUSIVE, 123)
    assert w == (5 << 34) | (2 << 32) | 123
    assert gf.fields(w) == (5, gf.INCLUSIVE, 123)
    bits = int(np.float32(-1.5).view(np.uint32))
    top = gf.word(gf.LAST_EPOCH, gf.AGGREGATE, bits)
    assert gf.fields(top) == (gf.LAST_EPOCH, gf.AGGREGATE, bits)
    assert top < 1 << 64 and gf.LAST_EPOCH == (1 << gf.EPOCH_BITS) - 1
    # the int64 a buffer holds gives the same fields
    as_int64 = int(torch.tensor([top - (1 << 64)], dtype=torch.int64)[0])
    assert gf.fields(as_int64) == gf.fields(top)
    assert gf.fields(gf.word(0, gf.EMPTY, 0)) == (0, gf.EMPTY, 0)
    with pytest.raises(ValueError):
        gf.word(gf.LAST_EPOCH + 1, gf.AGGREGATE, 0)
    with pytest.raises(ValueError):
        gf.word(1, 4, 0)


def test_flags_advance_the_epoch_and_zero_once():
    """Each launch takes the next epoch of its (device, stream); a buffer
    is zeroed when it is made (a grown one starts again at epoch 1), and
    again only when the epoch wraps."""
    flags, dev = gf.Flags(), torch.device("cpu")
    p1, e1 = flags.next(dev, 0, 4)
    p2, e2 = flags.next(dev, 0, 3)
    assert (e1, e2) == (1, 2) and p1 == p2
    assert flags.next(dev, 7, 4)[1] == 1          # another stream
    buf, _ = flags._bufs[(dev, 0)]
    buf.fill_(-1)
    p3, e3 = flags.next(dev, 0, 64)               # grown: fresh zeros
    grown, _ = flags._bufs[(dev, 0)]
    assert e3 == 1 and grown.numel() == 64 and not grown.any()
    assert p3 == grown.data_ptr()
    grown.fill_(-1)
    flags._bufs[(dev, 0)][1] = gf.LAST_EPOCH
    assert flags.next(dev, 0, 64)[1] == 1 and not grown.any()


def test_host_constants_are_the_headers():
    """The host's copies of the kernels' constants: flag layout and
    states, the filter-folds' piece (whole rounds of a float4 a thread),
    the FlatMap's scan scratch."""
    import re
    from repro_torch.core import codegen_cuda as cc

    def text(name):
        return (build.CSRC / name).read_text()

    flags, tfm = text("grid_flags.cuh"), text("tiled_flatmap.cuh")
    threads = int(re.search(r"THREADS = (\d+);", text("tile_copy.cuh"))[1])
    assert f"EPOCH_BITS = {gf.EPOCH_BITS};" in flags
    for name, value in (("EMPTY", gf.EMPTY), ("AGGREGATE", gf.AGGREGATE),
                        ("INCLUSIVE", gf.INCLUSIVE)):
        assert f"{name} = {value}u;" in flags
    assert fr.PIECE_ALIGN == 4 * threads
    struct = re.search(r"struct Scan \{(.*?)\};", tfm, re.S)[1]
    ints = sum(threads // 32 if "[WARPS]" in f else
               int(re.search(r"\[(\d+)\]", f)[1]) if "[" in f else 1
               for f in re.findall(r"int ([^;]+);", struct))
    assert 4 * ints == cc.FLATMAP_SCAN_BYTES


# ----------------------------------------------------- fused k-means
@pytest.mark.parametrize("auto_tile", [False, True])
def test_fused_kmeans_matches_jax(auto_tile):
    n, k, d = 256, 8, 16
    rng = np.random.RandomState(0)
    pts, cents = rng.randn(n, d).astype(np.float32), \
        rng.randn(k, d).astype(np.float32)
    kw = {"auto_tile": True} if auto_tile else {"block_n": 64}
    js, jc = jfused_kmeans(pts, cents, **kw)
    sums, counts = fused_kmeans_step(pts, cents, device="cpu", **kw)
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    idx = ((pts[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(idx, minlength=k))


def test_fused_kmeans_ties_go_to_the_lowest_index():
    pts = np.zeros((4, 2), np.float32)
    cents = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
    sums, counts = fused_kmeans_step(pts, cents, device="cpu")
    _, jc = jfused_kmeans(pts, cents)
    np.testing.assert_array_equal(counts.numpy(), [4, 0, 0, 0])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


# ------------------------------------------------------ ops, ref, plans
def test_ops_match_ref_and_the_kernels():
    x, y = _r(0, 64, 32), _r(1, 32, 48)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_array_equal(
        ops.matmul(x, y, use_kernel=False, device="cpu").numpy(),
        ref.matmul(tx, ty).numpy())
    np.testing.assert_allclose(ops.matmul(x, y, block_m=32, device="cpu"),
                               ref.matmul(tx, ty), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ref.matmul(tx, ty), jref.matmul(x, y),
                               rtol=2e-5, atol=2e-5)
    keys, vals = _keys(2, 256, 0, 8), _r(3, 256, 4)
    np.testing.assert_array_equal(
        ops.groupby(keys, vals, 8, use_kernel=False, device="cpu").numpy(),
        ref.groupby_fold(torch.as_tensor(keys), torch.as_tensor(vals),
                         8).numpy())
    np.testing.assert_allclose(ops.groupby(keys, vals, 8, device="cpu"),
                               jref.groupby_fold(keys, vals, 8),
                               rtol=1e-5, atol=1e-5)
    xs, ws = _r(4, 1024), _r(5, 1024)
    assert float(ops.filter_sum(xs, ws, -0.5, 0.8, use_kernel=False,
                                device="cpu")) == float(ref.filter_reduce(
                                    torch.as_tensor(xs), np.float32(-0.5),
                                    np.float32(0.8), torch.as_tensor(ws)))
    np.testing.assert_allclose(
        float(ops.filter_sum(xs, ws, -0.5, 0.8, device="cpu")),
        float(jref.filter_reduce(xs, jnp.float32(-0.5), jnp.float32(0.8),
                                 ws)), rtol=1e-4, atol=1e-4)


def test_resolve_plan_memoises_and_dispatches(monkeypatch):
    ops.clear_plan_memo()
    calls = []
    from repro_torch.core import dse
    select = dse.select_filter_reduce_blocks
    monkeypatch.setattr(dse, "select_filter_reduce_blocks",
                        lambda *a, **k: calls.append(a) or select(*a, **k))
    first = ops.resolve_plan("filter_reduce", 4096, tier=cost.TPU)
    again = ops.resolve_plan("filter_reduce", 4096, tier=cost.TPU)
    assert again is first and len(calls) == 1
    assert first == select(4096, tier=cost.TPU, cache=False)
    ops.resolve_plan("filter_reduce", 4096, device="cpu")
    assert len(calls) == 2         # another tier: another plan
    ops.clear_plan_memo()
    ops.resolve_plan("filter_reduce", 4096, tier=cost.TPU)
    assert len(calls) == 3


def test_resolve_plan_refuses_unknown_later_and_tuning_kinds():
    assert sorted(ops._SELECTORS) == sorted(jops._SELECTORS)
    with pytest.raises(ValueError, match="unknown plan kind"):
        ops.resolve_plan("conv", 1)
    # every kind resolves: paged_decode (the serving slice) as the
    # reference plans it
    from repro.core import dse as jdse
    assert ops.resolve_plan("paged_decode", 128, 64, tier=cost.TPU)[0] \
        == jdse.select_paged_decode_blocks(128, 64, cache=False)[0]
    from repro_torch.core.options import Options
    with pytest.raises(NotImplementedError, match="tuning-runtime"):
        ops.resolve_plan("gemm", 512, 512, 512, device="cpu",
                         options=Options(bucketing=True))


@pytest.mark.parametrize("budget", [None, cost.H100_SXM.onchip_bytes])
def test_select_gemm_tiles_matches_jax(budget):
    want = jautotile.select_gemm_tiles(512, 512, 512, vmem_budget=budget,
                                       cache=False)
    got = autotile.select_gemm_tiles(512, 512, 512, vmem_budget=budget,
                                     tier=cost.TPU)
    assert vars(got) == vars(want)


def test_kernel_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((8, 8), np.float32)
    v = np.ones(8, np.float32)
    k = np.zeros(8, np.int32)
    q = np.ones((1, 2, 8, 4), np.float32)
    x4, dt = np.ones((1, 8, 2, 4), np.float32), np.ones((1, 8, 2), np.float32)
    bc = np.ones((1, 8, 4), np.float32)
    for fn in (lambda: matmul(x, x), lambda: autotile.tuned_matmul(x, x),
               lambda: ops.matmul(x, x), lambda: ops.matmul(
                   x, x, use_kernel=False),
               lambda: filter_reduce(v, v, 0.0, 1.0),
               lambda: fused_filter_fold(v, v, 0.0, 1.0),
               lambda: groupby_fold(k, v, 4), lambda: ops.groupby(k, v, 4),
               lambda: fused_kmeans_step(x, x),
               lambda: ops.resolve_plan("gemm", 512, 512, 512),
               lambda: flash_attention(q, q, q), lambda: ops.attention(q, q, q),
               lambda: ops.attention(q, q, q, use_kernel=False),
               lambda: ops.resolve_plan("attention", 8, 8, 4),
               lambda: ssd_scan(x4, dt, v[:2], bc, bc),
               lambda: ops.ssd(x4, dt, v[:2], bc, bc),
               lambda: ops.ssd(x4, dt, v[:2], bc, bc, use_kernel=False),
               lambda: ops.resolve_plan("scan", 8, 4, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
