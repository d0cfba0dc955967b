"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a GPU every test skips with the reason.
This file imports only ``torch`` and ``repro_torch`` (no JAX), so it
runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

float32 rtol/atol 2e-3 for sums; tiled Map and FlatMap outputs bitwise
(count exact, tail zero); the launch counts show the kernels ran.  The
small single-pattern programs below (the paper's Table 2 filter and
histogram, and Maps and FlatMaps that reach the templates' other
paths) are shared with the CPU parity tests.  The hand-written kernels
of ``repro_torch.kernels`` are held against their plain versions:
float32 products at 1e-4 (K <= 256), bfloat16 outputs at 2e-2, sums at
1e-5 of their largest magnitude (the plain versions sum in float64),
counts and assignments exactly.  ``flash_attention`` and ``ssd_scan``
are held against their plain versions at 2e-4 in float32 (the reference
tests' tolerance; the SSD's atol scaled by the output's largest
magnitude) and 2e-2 in bfloat16; the SSD's four passes each launch
once a call, two calls are bitwise equal, and its bfloat16 result is
its float32 result on the widened inputs, rounded (every product is
float32 FFMA).  The per-variant launch counts show
which kernel of ``matmul`` and ``flash_attention`` ran (wgmma or FFMA,
and the combine of split keys).
"""
import operator
import re

import numpy as np
import pytest
import torch

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import ir
from repro_torch.core import pipeline as pl
from repro_torch.core.dse import PipelinePlan
from repro_torch.core.strip_mine import tile
from repro_torch.kernels import build
from repro_torch.kernels import filter_reduce as fr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_filter_fold as fff
from repro_torch.kernels import fused_kmeans as fkm
from repro_torch.kernels import groupby_fold as gbf
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.patterns import analytics as an

NAMES = sorted(an.PIPELINES)
TOL = dict(rtol=2e-3, atol=2e-3)


# ------------------------------------------------ single-pattern programs
def filter_program(n):
    """Table 2: x.flatMap{e => if (e > 0) [e] else []}."""
    x = ir.Tensor("x", (n,))
    return ir.FlatMap(
        domain=(n,), max_per_iter=1, reads=(ir.elem(x),),
        fn=lambda s, e: (e[..., None], (e > 0).to(torch.int32)),
        cuda="out[0] = in0[0];\ncount = in0[0] > 0.0f ? 1 : 0;", name="f")


def two_way_program(n):
    """A FlatMap emitting 2 values (e, -e) above 0.5, 1 value (e) above
    -0.5 and none below: ``max_per_iter`` 2."""
    x = ir.Tensor("x", (n,))

    def fn(s, e):
        count = torch.where(e > 0.5, 2, torch.where(e > -0.5, 1, 0))
        return torch.stack([e, -e], -1), count.to(torch.int32)

    return ir.FlatMap(
        domain=(n,), max_per_iter=2, reads=(ir.elem(x),), fn=fn,
        cuda=("out[0] = in0[0];\nout[1] = -in0[0];\n"
              "count = in0[0] > 0.5f ? 2 : (in0[0] > -0.5f ? 1 : 0);"),
        name="two")


def hist_program(n, k, clip=True):
    """Table 2: histogram x.groupByFold(0){e => (e, 1)}{_+_}.  With
    ``clip`` the key is clamped into [0, k); without, keys outside it
    are dropped by the template."""
    x = ir.Tensor("x", (n,))

    def fn(s, e):
        key = e.to(torch.int32)
        return (key.clamp(0, k - 1) if clip else key), torch.ones_like(e)

    key = f"min(max((int)in0[0], 0), {k - 1})" if clip else "(int)in0[0]"
    return ir.GroupByFold(
        domain=(n,), num_keys=k, init=lambda: torch.zeros(k),
        reads=(ir.elem(x),), fn=fn, combine=operator.add,
        cuda=f"key = {key};\nout[0] = 1.0f;", name="h")


def keyed_program(n, k, ew):
    """A keyed fold of ``ew``-wide rows into ``k`` keys: the row's key is
    ``keys[i]`` truncated (keys outside [0, k) dropped), its value the
    row ``x[i]``; the CAM of every width class."""
    keys = ir.Tensor("keys", (n,))
    x = ir.Tensor("x", (n, ew))
    return ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(ew,),
        init=lambda: torch.zeros((k, ew)),
        reads=(ir.elem(keys), ir.Access(x, lambda i: (i, 0), (1, ew))),
        fn=lambda s, kk, row: (kk.to(torch.int32),
                               row.reshape(kk.shape + (ew,))),
        combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {ew}; ++a) out[a] = in1[a];"),
        name="kv")


def keyed_inputs(n, k, ew, seed=0):
    """Seeded keys over [-2, k + 2) (about 4 / (k + 4) of them dropped)
    and normal rows."""
    rng = np.random.RandomState(seed)
    return {"keys": rng.randint(-2, k + 2, n).astype(np.float32),
            "x": rng.randn(n, ew).astype(np.float32)}


def keyed_reference(inp, k):
    keys = inp["keys"].astype(np.int64)
    keep = (keys >= 0) & (keys < k)
    out = np.zeros((k, inp["x"].shape[1]), np.float64)
    np.add.at(out, keys[keep], inp["x"][keep].astype(np.float64))
    return out


# (form, lanes, k, ew, block): each CAM form of fused_dag.cuh and each shape
# class -- ew 1 (each lane adds its own rows), ew 72 (not a multiple of 32),
# a tail piece (ew 5 in pieces of 2), a block that is not whole warps, the
# register form at its limit (64 words a lane) at P = 1 and P = 32, and
# just past it (the shared form)
CAM_SHAPES = [("register", 1, 8, 1, 256), ("register", 8, 4, 72, 256),
              ("register", 2, 16, 5, 48), ("register", 1, 64, 1, 256),
              ("register", 32, 64, 32, 64), ("shared", 32, 65, 1, 256),
              ("shared", 32, 32, 72, 64)]


def pairs_program(n):
    """A 1-D Map with a 2-wide element: each index reads the pair
    x[2i:2i+2] and writes [sum, product]."""
    x = ir.Tensor("x", (2 * n,))
    return ir.Map(
        domain=(n,), elem_shape=(2,),
        reads=(ir.Access(x, lambda i: (2 * i,), (2,)),),
        fn=lambda s, w: torch.stack([w[..., 0] + w[..., 1],
                                     w[..., 0] * w[..., 1]], -1),
        cuda="out[0] = in0[0] + in0[1];\nout[1] = in0[0] * in0[1];",
        name="pairs")


def column_pairs_program(m, n):
    """A 2-D Map reading a (2, 1) window of a (2m, n) matrix: the window
    is not one run of its tile, and neither is the tile of the matrix."""
    x = ir.Tensor("x", (2 * m, n))
    return ir.Map(
        domain=(m, n),
        reads=(ir.Access(x, lambda i, j: (2 * i, j), (2, 1)),),
        fn=lambda s, w: w[..., 0] - w[..., 1],
        cuda="out[0] = in0[0] - in0[1];", name="cols")


def _plain(kernel, inp):
    plain = cc.tiled_map_plain if kernel.spec.kind == "map" \
        else cc.tiled_flatmap_plain
    return plain(kernel.spec, inp)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_fused_dag_kernel_matches_plain_and_reference(name):
    _card()
    pipe, make_inputs, reference = an.PIPELINES[name](n=65536)
    host = make_inputs()
    inp = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    before = cc.fused_dag.launches
    kern = cc.lower_fused_pipeline(pipe)
    out = kern(**inp)
    torch.cuda.synchronize()
    assert cc.fused_dag.launches == before + len(kern.pipeline_plan.groups)
    assert all(how == "megakernel" for _, how in kern.group_lowerings)
    names = pl.output_names(pipe)
    out = out if isinstance(out, dict) else {names[0]: out}
    ref = reference(host)
    ref = ref if isinstance(ref, dict) else {names[0]: ref}
    plain = cc.fused_dag_plain(kern.group_calls[0].kernel.spec, inp)
    for k in out:
        assert out[k].is_cuda
        torch.testing.assert_close(out[k], plain[k], **TOL)
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k], **TOL)


@pytest.mark.cuda
def test_fused_dag_cam_drops_out_of_range_keys():
    _card()
    n, k = 4096, 4
    pipe, make_inputs, reference = an.PIPELINES["gda_moments"](n=n, k=k)
    host = make_inputs()
    host["labels"][:64] = np.linspace(-8, 8, 64).astype(np.float32)
    inp = {k_: torch.as_tensor(v).cuda() for k_, v in host.items()}
    out = cc.lower_fused_pipeline(pipe)(**inp)
    ref = reference(host)
    for name in ref:
        np.testing.assert_allclose(out[name].cpu().numpy(), ref[name], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gda", "kmeans", "gda_moments"])
def test_fused_dag_two_calls_are_bitwise_equal(name):
    """The CAM sums in one fixed order (lanes, row groups, warps,
    blocks): two calls give the same bits."""
    _card()
    pipe, make_inputs, _ = an.PIPELINES[name](n=65536)
    inp = {k: torch.as_tensor(v).cuda() for k, v in make_inputs().items()}
    kern = cc.lower_fused_pipeline(pipe)
    spec = kern.group_calls[0].kernel.spec
    assert {t.cam_form for t in spec.terminals} == {"register"}
    names = pl.output_names(pipe)
    first, second = (dict(zip(names, [out])) if torch.is_tensor(out) else out
                     for out in (kern(**inp), kern(**inp)))
    assert set(first) == set(names)
    for k in names:
        assert torch.equal(first[k], second[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", CAM_SHAPES, ids=str)
def test_cam_forms_match_plain(case):
    _card()
    form, lanes, k, ew, block = case
    n = 64 * block
    host = keyed_inputs(n, k, ew, seed=k + ew)
    call = cc.lower(tile(keyed_program(n, k, ew), {"kv": (block,)}))
    (t,) = call.kernel.spec.terminals
    assert (t.cam_form, t.cam_lanes) == (form, lanes)
    inp = {name: torch.as_tensor(v).cuda() for name, v in host.items()}
    before = cc.fused_dag.launches
    out = call(**inp)
    again = call(**inp)
    torch.cuda.synchronize()
    assert cc.fused_dag.launches == before + 2
    assert torch.equal(out, again)
    _sum_close(out, cc.fused_dag_plain(call.kernel.spec, inp)["kv"])
    _sum_close(out.cpu(), torch.as_tensor(keyed_reference(host, k)))


@pytest.mark.cuda
def test_fused_dag_depths_agree():
    """The plan's depth sets only the ring's slots: at depths 2, 3 and 4
    the same block walks the same steps, so the outputs are equal."""
    _card()
    pipe, make_inputs, _ = an.PIPELINES["gda_moments"](n=65536)
    inp = {k: torch.as_tensor(v).cuda() for k, v in make_inputs().items()}
    outs, ctas = [], []
    for depth in (2, 3, 4):
        plan = {"block": 256, "groups": [[0, 3]], "group_blocks": [256],
                "depths": [depth], "traffic_words": 0,
                "unfused_traffic_words": 0, "vmem_bytes": 0,
                "modeled_seconds": 0.0}
        kern = cc.lower_fused_pipeline(pipe, plan=PipelinePlan.from_json(plan))
        outs.append(kern(**inp))
        ctas.append(kern.group_calls[0].kernel.ctas(torch.device("cuda", 0)))
    assert len(set(ctas)) == 1, ctas
    for out in outs[1:]:
        for k in out:
            assert torch.equal(out[k], outs[0][k]), k


@pytest.mark.cuda
def test_tiled_gemm_kernel_matches_plain():
    _card()
    p, sizes, make_inputs, reference = an.gemm(256, 256, 512)
    host = make_inputs()
    inp = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    before = cc.tiled_gemm.launches
    out = cc.lower(tile(p, sizes))(**inp)
    assert cc.tiled_gemm.launches == before + 1
    plain = cc.tiled_gemm_plain(inp["x"], inp["y"], bm=64, bn=64, bk=64)
    torch.testing.assert_close(out, plain, **TOL)
    np.testing.assert_allclose(out.cpu().numpy(), reference(host), **TOL)


# (m, n, k, bm, bn, bk, depth): the analytics default, the FFMA-shaped
# tile at depth 3, the 8x4 and 4x4 micro-tiles, a non-square product at
# depth 4, a tile below 128 threads
GEMM_TILES = [(256, 256, 512, 64, 64, 64, 2), (256, 384, 256, 128, 128, 32, 3),
              (192, 128, 320, 64, 32, 16, 2), (128, 96, 64, 32, 32, 32, 2),
              (320, 192, 448, 64, 64, 32, 4), (64, 64, 128, 32, 64, 8, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMM_TILES, ids=str)
def test_tiled_gemm_at_the_plans_tile_and_depth(case):
    _card()
    m, n, k, bm, bn, bk, depth = case
    x, y = _randn(0, m, k), _randn(1, k, n)
    before = cc.tiled_gemm.launches
    out = cc.tiled_gemm(x, y, bm=bm, bn=bn, bk=bk, depth=depth)
    torch.cuda.synchronize()
    assert cc.tiled_gemm.launches == before + 1
    plain = cc.tiled_gemm_plain(x, y, bm=bm, bn=bn, bk=bk)
    torch.testing.assert_close(out, plain, **TOL)
    want = x.double() @ y.double()
    torch.testing.assert_close(out.double(), want, **TOL)


@pytest.mark.cuda
def test_kernel_refuses_a_plan_beyond_the_cards_shared_memory():
    _card()
    # 4 tiles x 16384 words x 4 slots: 1 MiB of shared memory
    pipe, make_inputs, _ = an.PIPELINES["tpchq6"](n=65536)
    plan = {"block": 16384, "groups": [[0, 2]], "group_blocks": [16384],
            "depths": [4], "traffic_words": 0, "unfused_traffic_words": 0,
            "vmem_bytes": 0, "modeled_seconds": 0.0}
    kern = cc.lower_fused_pipeline(pipe, plan=PipelinePlan.from_json(plan))
    assert kern.group_lowerings == (("q6_sum", "megakernel"),)
    inp = {k: torch.as_tensor(v).cuda() for k, v in make_inputs().items()}
    with pytest.raises(ValueError, match="shared memory"):
        kern(**inp)


@pytest.mark.cuda
def test_group_without_a_megakernel_raises_on_the_card():
    _card()
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
    with pytest.raises(NotImplementedError, match="'max' has no CUDA"):
        cc.lower_fused_pipeline(pipe)


# ------------------------------------------- single-pattern templates
MAPS = [("outerprod", lambda: an.outerprod(256, 192)[0], {"outer": (64, 64)}),
        ("pairs", lambda: pairs_program(1024), {"pairs": (256,)}),
        ("columns", lambda: column_pairs_program(64, 96),
         {"cols": (16, 32)})]


def _inputs(p, seed=0):
    rng = np.random.RandomState(seed)
    return {t.name: torch.as_tensor(rng.randn(*t.shape).astype(np.float32))
            .cuda() for t in ir.inputs_of(p)}


@pytest.mark.cuda
@pytest.mark.parametrize("name,build,sizes", MAPS)
def test_tiled_map_kernel_matches_plain_bitwise(name, build, sizes):
    _card()
    p = build()
    inp = _inputs(p)
    for depth in (2, 3):
        call = cc.lower(tile(p, sizes), depth=depth)
        before = cc.tiled_map.launches
        out = call(**inp)
        torch.cuda.synchronize()
        assert cc.tiled_map.launches == before + 1
        assert torch.equal(out, _plain(call.kernel, inp)), (name, depth)


FLATMAPS = [("filter", filter_program, 4096, 256),
            ("filter", filter_program, 1000, 40),
            ("two_way", two_way_program, 4096, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,build,n,b", FLATMAPS)
def test_tiled_flatmap_kernel_matches_plain_bitwise(name, build, n, b):
    _card()
    p = build(n)
    inp = _inputs(p, seed=n)
    call = cc.lower(tile(p, {p.name: (b,)}))
    before = cc.tiled_flatmap.launches
    buf, count = call(**inp)
    torch.cuda.synchronize()
    assert cc.tiled_flatmap.launches == before + 1
    assert count.is_cuda and count.dtype == torch.int32 and count.dim() == 0
    want_buf, want_count = _plain(call.kernel, inp)
    assert int(count) == int(want_count)
    assert torch.equal(buf, want_buf)
    assert not bool(buf[int(count):].any())


@pytest.mark.cuda
def test_tiled_groupby_runs_the_cam_and_drops_out_of_range_keys():
    _card()
    n, k = 4096, 8
    xs = np.random.RandomState(3).randint(-3, k + 3, n).astype(np.float32)
    keep = xs.astype(np.int32)
    want = np.bincount(keep[(keep >= 0) & (keep < k)], minlength=k)
    before = cc.fused_dag.launches
    out = cc.lower(tile(hist_program(n, k, clip=False), {"h": (256,)}))(
        x=torch.as_tensor(xs).cuda())
    torch.cuda.synchronize()
    assert cc.fused_dag.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), want.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["outerprod", "gda", "filter"])
def test_lower_auto_on_the_card(name):
    _card()
    if name == "filter":
        p = filter_program(1 << 16)
        host = {"x": np.random.RandomState(0).randn(1 << 16).astype(np.float32)}
    else:
        p, _, make_inputs, reference = an.SUITE[name](
            **({"m": 1024, "n": 512} if name == "outerprod" else {"n": 65536}))
        host = make_inputs()
    inp = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    kern = cc.lower_auto(p)
    assert kern.tile_plan.vmem_bytes <= torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    out = kern(**inp)
    torch.cuda.synchronize()
    if name == "filter":
        buf, count = out
        want = host["x"][host["x"] > 0]
        assert int(count) == want.size
        np.testing.assert_array_equal(buf.cpu().numpy()[:want.size], want)
        assert not bool(buf[want.size:].any())
    elif name == "outerprod":
        np.testing.assert_array_equal(out.cpu().numpy(), reference(host))
    else:
        np.testing.assert_allclose(out.cpu().numpy(), reference(host), **TOL)


def _offset_view(t):
    """``t``'s values in a view that starts one word past a 16-byte
    boundary."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:].copy_(t.reshape(-1))
    return big[1:].view(t.shape)


ALIGNMENT = {
    "outerprod": lambda: (an.outerprod(256, 192)[0], {"outer": (64, 64)}),
    "filter": lambda: (filter_program(4096), {"f": (256,)}),
    "hist": lambda: (hist_program(4096, 8), {"h": (256,)}),
    "gemm": lambda: an.gemm(256, 256, 512)[:2],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ALIGNMENT))
def test_inputs_off_a_16_byte_boundary(name):
    """The kernels read 16-byte pieces: a wrapper refuses a view that
    starts elsewhere, and the lowered call copies it first."""
    _card()
    p, sizes = ALIGNMENT[name]()
    call = cc.lower(tile(p, sizes))
    inp = _inputs(p)
    odd = {k: _offset_view(v) for k, v in inp.items()}
    assert all(v.data_ptr() % 16 for v in odd.values())
    want, got = call(**inp), call(**odd)
    torch.cuda.synchronize()
    if name != "filter":          # the FlatMap returns (buffer, count)
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="16-byte"):
        if name == "gemm":
            cc.tiled_gemm(odd["x"], odd["y"], bm=64, bn=64, bk=64)
        elif name == "hist":
            cc.fused_dag(call.kernel, odd)
        else:
            run = cc.tiled_map if name == "outerprod" else cc.tiled_flatmap
            run(call.kernel, odd)


# the programs no template takes, tiled: three SUITE programs at their own
# tiles, and the GEMM at the tiles the DSE picks on the card's budget (a
# write-once Map over per-element K folds, not the Table 3 form)
NO_TEMPLATE = {
    "sumrows": lambda: an.sumrows()[:2],
    "tpchq6": lambda: an.tpchq6()[:2],
    "kmeans": lambda: an.kmeans()[:2],
    "gemm_at_the_cards_budget": lambda: (
        an.gemm(512, 512, 512)[0], {"gemm": (128, 512), "gemm_k": (512,)}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NO_TEMPLATE))
def test_patterns_without_a_template_raise_on_the_card(name):
    _card()
    p, sizes = NO_TEMPLATE[name]()
    with pytest.raises(NotImplementedError):
        cc.lower(tile(p, sizes, vmem_budget_words=232_448 // 4))


# ------------------------------------------------ hand-written kernels
def _randn(seed, *shape, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(*shape).astype(np.float32)).cuda() \
        .to(dtype)


def _optin():
    return torch.cuda.get_device_properties(0).shared_memory_per_block_optin


def _sum_close(got, want):
    """Within 1e-5 of the largest magnitude of ``want``."""
    limit = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got.double() - want.double()).abs().max()) <= limit


# (m, k, n, block_m, block_n, block_k): the reference's shapes and tiny
# blocks, and blocks wider than the kernel's 64-word sub-tile
MATMULS = [(128, 128, 128, 128, 128, 128), (256, 128, 64, 128, 64, 64),
           (64, 256, 128, 32, 128, 128), (8, 16, 8, 8, 8, 16),
           (192, 96, 320, 96, 160, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMULS)
def test_matmul_kernel_matches_plain(shape):
    _card()
    m, k, n, bm, bn, bk = shape
    x, y = _randn(0, m, k), _randn(1, k, n)
    before = mm.matmul.launches
    out = mm.matmul(x, y, block_m=bm, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, mm.matmul_plain(x, y, torch.float32),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_kernel_bfloat16(out_dtype):
    _card()
    x, y = (_randn(s, 64, 64, dtype=torch.bfloat16) for s in (2, 3))
    out = mm.matmul(x, y, block_m=32, block_n=32, block_k=32,
                    out_dtype=out_dtype)
    want = mm.matmul_plain(x, y, out.dtype)
    assert out.dtype == (out_dtype or torch.bfloat16)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_matmul_auto_tile_and_ops_on_the_card():
    _card()
    x, y = _randn(0, 512, 512), _randn(1, 512, 512)
    ops.clear_plan_memo()
    blocks, _ = ops.resolve_plan("gemm", 512, 512, 512, device=x.device)
    assert blocks == (128, 512, 512)
    before = mm.matmul.launches
    out = mm.matmul(x, y, auto_tile=True)
    assert ops.matmul(x, y).is_cuda and mm.matmul.launches == before + 2
    torch.testing.assert_close(out, ops.matmul(x, y, use_kernel=False),
                               rtol=1e-4, atol=1e-4)


# (m, k, n): bfloat16 products whose m and n are not multiples of the
# 128 x 128 tile, and whose k is or is not a multiple of 8 (TMA's rule)
BF16_MATMULS = [(200, 136, 72, "wgmma"), (8, 16, 8, "wgmma"),
                (130, 4096, 264, "wgmma"), (96, 60, 40, "ffma"),
                (72, 64, 36, "ffma")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,which", BF16_MATMULS)
def test_matmul_bfloat16_variants(m, k, n, which):
    _card()
    x, y = (_randn(s, *shape, dtype=torch.bfloat16)
            for s, shape in ((4, (m, k)), (5, (k, n))))
    assert mm.variant(x.dtype, y.dtype, k, n) == which
    before = (mm.matmul.wgmma_launches, mm.matmul.ffma_launches)
    for out_dtype in (torch.bfloat16, torch.float32):
        out = mm.matmul(x, y, block_m=m, block_n=n, block_k=k,
                        out_dtype=out_dtype)
        assert out.dtype == out_dtype and out.shape == (m, n)
        torch.testing.assert_close(
            out.float(), mm.matmul_plain(x, y, out_dtype).float(),
            rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    ran = (mm.matmul.wgmma_launches - before[0],
           mm.matmul.ffma_launches - before[1])
    assert ran == ((2, 0) if which == "wgmma" else (0, 2))


FILTERS = [(fr.filter_reduce, fr.filter_reduce_plain),
           (fff.fused_filter_fold, fff.fused_filter_fold_plain)]


@pytest.mark.cuda
@pytest.mark.parametrize("fn,plain", FILTERS)
@pytest.mark.parametrize("block_t", [128, 1000, 8192])
def test_filter_fold_kernels_match_plain(fn, plain, block_t):
    _card()
    t = 8000 if block_t == 1000 else 16384
    x, w = _randn(0, t), _randn(1, t)
    x[:3] = torch.tensor([0.7, 0.9, 0.8], dtype=torch.float32)   # on bounds
    w[3] = float("nan")
    x[3] = 5.0                         # fails the predicate: adds 0
    before = fn.launches
    got = fn(x, w, 0.7, 0.9, block_t=block_t)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dim() == 0
    _sum_close(got, plain(x, w, 0.7, 0.9))


# each hand kernel on inputs made from (seed, shape) tensors
HAND = {
    "matmul": lambda a, b: mm.matmul(a, b, block_m=64, block_n=64,
                                     block_k=32),
    "filter_reduce": lambda a, b: fr.filter_reduce(
        a.reshape(-1), b.reshape(-1), -0.5, 0.8, block_t=512),
    "fused_filter_fold": lambda a, b: fff.fused_filter_fold(
        a.reshape(-1), b.reshape(-1), -0.5, 0.8, block_t=512),
    "groupby_fold": lambda a, b: gbf.groupby_fold(
        (a.reshape(-1) * 4).to(torch.int32), b.reshape(-1), 8, block_t=512),
    "fused_kmeans": lambda a, b: fkm.fused_kmeans_step(a, b[:8],
                                                       block_n=16)[0],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_kernels_take_a_view_off_a_16_byte_boundary(name):
    """The hand kernels read scalars, or copy such a view before a 16-byte
    ``cp.async`` reads it (fused_kmeans and the filter-folds): a view one
    word past a 16-byte boundary gives the aligned input's result,
    bitwise for the kernels whose sums take one fixed order."""
    _card()
    a, b = _randn(0, 64, 64), _randn(1, 64, 64)
    oa, ob = _offset_view(a), _offset_view(b)
    assert oa.data_ptr() % 16 and ob.data_ptr() % 16
    got, want = HAND[name](oa, ob), HAND[name](a, b)
    if name == "matmul":
        _sum_close(got, want)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_staged_filter_fold_refuses_a_step_beyond_shared_memory():
    _card()
    x = _randn(0, 1 << 17)
    before = fff.fused_filter_fold.launches
    with pytest.raises(ValueError, match="shared memory"):
        fff.fused_filter_fold(x, x, 0.0, 1.0, block_t=1 << 17)
    assert fff.fused_filter_fold.launches == before


# ---------------------------------- the one-launch kernels (grid_flags)
def _kernels_of_calls(fn, calls):
    """name -> launches of the device kernels ``calls`` calls of ``fn``
    make, by torch.profiler after a traced but discarded warm-up call
    (the tracer drops the first kernels it sees, and may drop others: it
    shows at most what ran); up to three traces, until one shows any."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls,
                                       repeat=1)) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {e.key: e.count for e in prof.key_averages()
                if (getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0)) > 0}
        if seen:
            break
    return seen


def _flatmap_call(n, b, depth=2):
    return cc.lower(tile(filter_program(n), {"f": (b,)}), depth=depth)


def _flatmap_inputs(n, seed):
    return {"x": torch.as_tensor(np.random.RandomState(seed).randn(n)
                                 .astype(np.float32)).cuda()}


def _flatmap_equal(out, want):
    assert out[1].is_cuda and out[1].dtype == torch.int32 \
        and out[1].dim() == 0
    assert int(out[1]) == int(want[1])
    assert torch.equal(out[0], want[0])
    assert not bool(out[0][int(out[1]):].any())


# entry point -> run(inputs), plain(inputs), inputs(seed), equal(got, want)
ONE_LAUNCH = {
    "filter_reduce": (
        lambda xw: fr.filter_reduce(*xw, -0.5, 0.8, block_t=1024),
        lambda xw: fr.filter_reduce_plain(*xw, -0.5, 0.8),
        lambda seed: (_randn(seed, 1 << 16), _randn(seed + 1, 1 << 16)),
        _sum_close),
    "fused_filter_fold": (
        lambda xw: fff.fused_filter_fold(*xw, -0.5, 0.8, block_t=1024),
        lambda xw: fff.fused_filter_fold_plain(*xw, -0.5, 0.8),
        lambda seed: (_randn(seed, 1 << 16), _randn(seed + 1, 1 << 16)),
        _sum_close),
    "tiled_flatmap": (
        lambda inp: _FLATMAP(**inp),
        lambda inp: _plain(_FLATMAP.kernel, inp),
        lambda seed: _flatmap_inputs(1 << 16, seed),
        _flatmap_equal),
}
_FLATMAP = None


def _one_launch(name):
    global _FLATMAP
    if name == "tiled_flatmap" and _FLATMAP is None:
        _FLATMAP = _flatmap_call(1 << 16, 256)
    return ONE_LAUNCH[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONE_LAUNCH))
def test_one_launch_kernels_hold_a_b_a(name):
    """Calls A, B, A back to back on different inputs, with no
    synchronisation between them: each equals its plain version (a flag
    word left by the call before would shift a prefix or a partial), and
    the two A calls are bitwise equal."""
    _card()
    run, plain, make, equal = _one_launch(name)
    a, b = make(0), make(10)
    first, second, third = run(a), run(b), run(a)
    torch.cuda.synchronize()
    equal(first, plain(a))
    equal(second, plain(b))
    equal(third, plain(a))
    if name == "tiled_flatmap":
        assert torch.equal(first[0], third[0]) \
            and int(first[1]) == int(third[1])
    else:
        assert torch.equal(first, third)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONE_LAUNCH))
def test_one_launch_kernels_make_one_launch_a_call(name):
    """One call, one kernel launch: the wrapper counts one, and a trace
    of three calls shows that kernel alone (no combine, no memset), at
    most once a call."""
    _card()
    run, _, make, _ = _one_launch(name)
    fn = {"filter_reduce": fr.filter_reduce,
          "fused_filter_fold": fff.fused_filter_fold,
          "tiled_flatmap": cc.tiled_flatmap}[name]
    inp = make(3)
    before = fn.launches
    run(inp)
    assert fn.launches == before + 1
    seen = _kernels_of_calls(lambda: run(inp), 3)
    kernel = "flatmap_kernel" if name == "tiled_flatmap" \
        else "filter_fold_kernel"
    assert len(seen) == 1 and kernel in next(iter(seen)), seen
    assert 1 <= next(iter(seen.values())) <= 3, seen


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONE_LAUNCH))
def test_one_launch_kernels_with_the_grid_well_above_the_blocks(name):
    """16,384 grid steps on at most a few hundred resident blocks: every
    block walks many steps, and the look-back crosses many rounds."""
    _card()
    n, b = 1 << 21, 128
    if name == "tiled_flatmap":
        call = _flatmap_call(n, b)
        inp = _flatmap_inputs(n, 4)
        got = call(**inp)
        ctas = call.kernel.ctas(torch.device("cuda", 0))
        _flatmap_equal(got, _plain(call.kernel, inp))
    else:
        fn = fr.filter_reduce if name == "filter_reduce" \
            else fff.fused_filter_fold
        plain = fr.filter_reduce_plain if name == "filter_reduce" \
            else fff.fused_filter_fold_plain
        x, w = _randn(4, n), _randn(5, n)
        got = fn(x, w, -0.5, 0.8, block_t=b)
        ctas = fn.ctas
        _sum_close(got, plain(x, w, -0.5, 0.8))
    assert n // b >= 16 * ctas, (n // b, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("kept", ["none", "all"])
@pytest.mark.parametrize("n,b", [(1 << 16, 256), (1000, 40)])
def test_tiled_flatmap_keeps_none_or_all(kept, n, b):
    """A count of 0 leaves the whole buffer zero; a count of n keeps
    every value, so the buffer is the input and no tail is left."""
    _card()
    call = _flatmap_call(n, b)
    x = np.abs(np.random.RandomState(n).randn(n).astype(np.float32)) + 0.5
    x = -x if kept == "none" else x
    buf, count = call(x=torch.as_tensor(x).cuda())
    torch.cuda.synchronize()
    want = 0 if kept == "none" else n
    assert int(count) == want
    if kept == "none":
        assert not bool(buf.any())
    else:
        np.testing.assert_array_equal(buf.cpu().numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_tiled_flatmap_at_each_ring_depth(depth):
    """The ring at the plan's DEPTH slots: bitwise against the plain
    version and stable over two calls."""
    _card()
    call = _flatmap_call(1 << 18, 2048, depth)
    inp = _flatmap_inputs(1 << 18, depth)
    first, second = call(**inp), call(**inp)
    _flatmap_equal(first, _plain(call.kernel, inp))
    assert torch.equal(first[0], second[0])


# (staged, t, block_t, depth): whole steps; steps off a 16-byte boundary;
# pieces of a step too large for the ring (off a boundary too)
FILTER_RINGS = [(False, 1 << 16, 1024, 2), (True, 1 << 16, 1024, 3),
                (False, 96_000, 9600, 3), (True, 96_000, 9600, 2),
                (False, 96_000, 9600, 4), (True, 8190, 1365, 2),
                (False, 8190, 1365, 3), (False, 5, 1, 2),
                (False, 1 << 18, 1 << 18, 2), (True, 280_000, 40_000, 2),
                (True, 200_005, 40_001, 3), (False, 3 * 65_537, 65_537, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FILTER_RINGS, ids=str)
def test_filter_fold_ring_forms(case):
    """Every ring form the wrapper takes: a whole step a slot, a step off
    a 16-byte boundary (4-byte copies at its ends), pieces of a step, at
    depths 2 to 4; two calls bitwise equal, the sum within 1e-5 of the
    plain version's largest magnitude."""
    _card()
    staged, t, bt, depth = case
    lo, hi = float(np.float32(0.7)), float(np.float32(0.9))
    x, w = _randn(20, t), _randn(21, t)
    x[:3] = torch.tensor([lo, hi, 0.8], dtype=torch.float32)[:t]
    first, _, form = fr.launch(x, w, lo, hi, bt, staged, depth)
    second, _, _ = fr.launch(x, w, lo, hi, bt, staged, depth)
    torch.cuda.synchronize()
    assert form == fr.ring_form(bt, depth, staged, _optin())
    assert (form.pieces > 1) == (form.piece < bt)
    assert torch.equal(first, second)
    _sum_close(first, fr.filter_fold_plain(x, w, lo, hi))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [fr.filter_reduce, fff.fused_filter_fold])
def test_filter_folds_take_the_plans_ring(fn):
    """auto_tile=True on TPC-H Q6's 6,000,000 rows: the DSE's block and
    depth for the card, one block a step's ring per SM at most."""
    _card()
    t = 6_000_000
    x, w = _randn(30, t), _randn(31, t)
    kind = "filter_reduce" if fn is fr.filter_reduce else "fused_filter_fold"
    block, plan = ops.resolve_plan(kind, t, device="cuda")
    first = fn(x, w, -0.5, 0.8, auto_tile=True)
    second = fn(x, w, -0.5, 0.8, auto_tile=True)
    assert (fn.form.block_t, fn.form.depth, fn.form.piece) \
        == (block, plan.depth, block)
    assert fn.form.ring_bytes == plan.vmem_bytes
    assert torch.equal(first, second)
    _sum_close(first, fr.filter_fold_plain(x, w, -0.5, 0.8))


@pytest.mark.cuda
def test_one_launch_kernels_build_without_a_stack_frame_or_an_atomic():
    """ptxas reports no stack frame for the filter-fold library and the
    FlatMap kernels these tests build, and their SASS has cp.async
    (LDGSTS) and no atomic (ATOMS, ATOMG, ATOM, RED)."""
    import os
    import subprocess

    _card()
    items = [(fr.LIB.name, fr.LIB.source)]
    for n, b, depth in [(1 << 16, 256, 2), (1 << 18, 2048, 3)]:
        kern = _flatmap_call(n, b, depth).kernel
        items.append((kern.name, kern.source))
    kern = cc.lower(tile(two_way_program(4096), {"two": (512,)})).kernel
    items.append((kern.name, kern.source))
    exe = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                       "bin", "cuobjdump")
    for p in build.compile_all(items):
        log = p.with_suffix(".log").read_text()
        frames = [int(b) for b in re.findall(r"(\d+) bytes stack frame", log)]
        assert frames and not any(frames), (p.name, log)
        sass = subprocess.run([exe, "-sass", str(p)], capture_output=True,
                              text=True, check=True).stdout
        assert re.search(r"\bLDGSTS\b", sass), p.name
        assert not re.search(r"\b(ATOMS|ATOMG|ATOM|RED)\b", sass), p.name


GROUPBYS = [(512, 16, 4, 128), (256, 8, 1, 256), (128, 64, 8, 32),
            (4096, 8, 0, 512)]          # E = 0: 1-D values


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,ew,bt", GROUPBYS)
def test_groupby_fold_kernel_matches_plain(t, k, ew, bt):
    _card()
    rng = np.random.RandomState(t)
    keys = torch.as_tensor(rng.randint(-2, k + 2, t).astype(np.int32)).cuda()
    vals = _randn(1, *((t, ew) if ew else (t,)))
    before = gbf.groupby_fold.launches
    out = gbf.groupby_fold(keys, vals, k, block_t=bt)
    torch.cuda.synchronize()
    assert gbf.groupby_fold.launches == before + 1
    assert gbf.groupby_fold.form == gbf.table_form(k, max(ew, 1), _optin())[0]
    want = gbf.groupby_fold_plain(keys, vals, k)
    assert out.shape == want.shape
    _sum_close(out, want)
    assert torch.equal(out, gbf.groupby_fold(keys, vals, k, block_t=bt))


# one table of each form of groupby_fold.table_form
GROUPBY_FORMS = [("register", 8, 1), ("register", 16, 4),
                 ("shared", 64, 8), ("shared", 64, 1), ("shared", 3, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("form,k,ew", GROUPBY_FORMS)
def test_groupby_fold_runs_the_form_its_rule_gives(form, k, ew):
    """Each form launched once and counted as its own; keys outside the
    table dropped; two calls bitwise equal."""
    _card()
    assert gbf.table_form(k, ew, _optin())[0] == form
    t = 8192
    keys = torch.as_tensor(np.random.RandomState(k + ew).randint(
        -1, k + 1, t).astype(np.int32)).cuda()
    vals = _randn(2, t, ew)
    before = (gbf.groupby_fold.register_launches,
              gbf.groupby_fold.shared_launches)
    out = gbf.groupby_fold(keys, vals, k, block_t=1024)
    torch.cuda.synchronize()
    ran = (gbf.groupby_fold.register_launches - before[0],
           gbf.groupby_fold.shared_launches - before[1])
    assert ran == ((1, 0) if form == "register" else (0, 1))
    _sum_close(out, gbf.groupby_fold_plain(keys, vals, k))
    assert torch.equal(out, gbf.groupby_fold(keys, vals, k, block_t=1024))


@pytest.mark.cuda
def test_groupby_fold_counts_are_exact_and_drop_keys_outside():
    _card()
    keys = torch.tensor([0, 1, -1, 8, 3, 9, 2, 7], dtype=torch.int32).cuda()
    out = ops.groupby(keys, torch.ones(8).cuda(), 8, block_t=4)
    assert out.tolist() == [1, 1, 1, 1, 0, 0, 0, 1]
    keys = torch.as_tensor(np.random.RandomState(0).randint(0, 8, 1 << 16)
                           .astype(np.int32)).cuda()
    counts = gbf.groupby_fold(keys, torch.ones(1 << 16).cuda(), 8,
                              auto_tile=True)
    assert torch.equal(counts, torch.bincount(keys, minlength=8).float())


@pytest.mark.cuda
def test_groupby_fold_refuses_a_table_beyond_shared_memory():
    _card()
    keys = torch.zeros(1024, dtype=torch.int32).cuda()
    before = gbf.groupby_fold.launches
    with pytest.raises(ValueError, match="shared memory"):
        gbf.groupby_fold(keys, torch.ones(1024, 64).cuda(), 1024)
    assert gbf.groupby_fold.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,block_n", [(4096, 8, 16, 1024),
                                           (1000, 5, 3, 200)])
def test_fused_kmeans_kernel_matches_plain(n, k, d, block_n):
    _card()
    pts, cents = _randn(0, n, d), _randn(1, k, d)
    cents[k - 1] = cents[0]               # a tie: the lower index wins
    before = fkm.fused_kmeans_step.launches
    sums, counts = fkm.fused_kmeans_step(pts, cents, block_n=block_n)
    torch.cuda.synchronize()
    assert fkm.fused_kmeans_step.launches == before + 1
    want_s, want_c = fkm.fused_kmeans_plain(pts, cents)
    assert torch.equal(counts, want_c) and float(counts[k - 1]) == 0.0
    _sum_close(sums, want_s)
    again = fkm.fused_kmeans_step(pts, cents, block_n=block_n)
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])


# (n, k, d, block_n, depth, lanes): each CAM form of the sums (column
# slots 1, 4 and the rule's 8 at d = 64), 16-byte and 4-byte rows, ring
# depths 2 to 4, a block that is not a multiple of 32 rows
KMEANS_FORMS = [(8192, 8, 16, 1024, 3, 1), (8192, 8, 16, 1024, 3, 4),
                (4096, 8, 64, 128, 4, None), (4000, 4, 6, 200, 2, 2),
                (6000, 8, 8, 1000, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,block_n,depth,lanes", KMEANS_FORMS)
def test_fused_kmeans_forms_match_plain(n, k, d, block_n, depth, lanes):
    _card()
    pts, cents = _randn(3, n, d), _randn(4, k, d)
    sums, counts = fkm.fused_kmeans_step(pts, cents, block_n=block_n,
                                         depth=depth, lanes=lanes)
    torch.cuda.synchronize()
    want = fkm.kmeans_lanes(k, d) if lanes is None else lanes
    assert fkm.fused_kmeans_step.lanes == want
    want_s, want_c = fkm.fused_kmeans_plain(pts, cents)
    assert torch.equal(counts, want_c)
    _sum_close(sums, want_s)
    again = fkm.fused_kmeans_step(pts, cents, block_n=block_n, depth=depth,
                                  lanes=lanes)
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])


@pytest.mark.cuda
def test_keyed_kernels_build_without_a_stack_frame():
    """ptxas keeps no accumulator of the keyed kernels in local memory:
    every instantiation the tests and chip_smoke build reports no stack
    frame."""
    _card()
    optin = _optin()
    libs = [gbf.library(k, ew, bt, *gbf.table_form(k, ew, optin))
            for k, ew, bt in [(16, 4, 128), (8, 1, 256), (64, 8, 32),
                              (8, 1, 512), (8, 1, 4), (8, 1, 8192),
                              (64, 8, 2048), (64, 1, 1024), (3, 80, 1024),
                              (16, 4, 1024), (8, 1, 1024), (64, 8, 1024)]]
    libs += [fkm.library(k, d, bn, depth, lanes or fkm.kmeans_lanes(k, d))
             for n, k, d, bn, depth, lanes in KMEANS_FORMS
             + [(0, 8, 16, 1024, 3, 1), (0, 8, 16, 1024, 3, 4),
                (0, 8, 16, 1024, 2, None), (0, 5, 3, 200, 2, None),
                (0, 8, 64, 16, 2, None)]]
    paths = build.compile_all([(lib.name, lib.source) for lib in libs])
    for p in paths:
        log = p.with_suffix(".log").read_text()
        frames = [int(b) for b in re.findall(r"(\d+) bytes stack frame", log)]
        assert frames and not any(frames), (p.name, log)


@pytest.mark.cuda
def test_fused_kmeans_matches_the_generated_megakernel():
    """The hand-written kernel and the compiler's fused DAG of
    kmeans_pipeline compute the same step."""
    _card()
    pipe, make_inputs, _ = an.PIPELINES["kmeans"](n=8192)
    inp = {k: torch.as_tensor(v).cuda() for k, v in make_inputs().items()}
    gen = cc.lower_fused_pipeline(pipe)(**inp)
    sums, counts = fkm.fused_kmeans_step(inp["points"], inp["centroids"],
                                         auto_tile=True)
    assert torch.equal(counts, gen["km_counts"])
    _sum_close(sums, gen["km_sums"])


# (b, hq, hkv, sq, sk, d, block_q, block_k, causal, window): MHA, GQA, MQA,
# a decode row, kv longer than q, sq > sk (rows that see no key), a window,
# non-causal, head dims 16 and 80, a block_q of three 64-row sub-tiles and
# an odd one, keys not a multiple of the kernel's 64-key chunk
ATTENTION = [
    (1, 4, 4, 128, 128, 64, 64, 64, True, None),
    (2, 8, 2, 128, 128, 32, 128, 64, True, None),
    (1, 4, 1, 64, 64, 32, 32, 32, True, None),
    (2, 8, 2, 1, 512, 64, 1, 128, True, None),
    (1, 2, 2, 64, 256, 32, 64, 64, True, None),
    (1, 2, 1, 128, 32, 16, 64, 32, True, None),
    (1, 4, 2, 256, 256, 128, 128, 64, True, 64),
    (1, 2, 2, 64, 96, 32, 32, 32, False, None),
    (1, 4, 2, 192, 192, 80, 192, 96, True, None),
    (1, 2, 1, 96, 160, 16, 96, 160, False, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTENTION, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(case, dtype):
    _card()
    b, hq, hkv, sq, sk, d, bq, bk, causal, window = case
    q, k, v = (_randn(s, *shape, dtype=dtype) for s, shape in
               enumerate([(b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    block_k=bk)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


# (b, hq, hkv, sq, sk, d, causal, window): tiles mixing rows that see no
# key with rows that do, over several chunks (sq > sk); a window whose
# early chunks every late tile skips; decode at group 1, 4 and 8 over a
# key count that does not divide into the splits; and a batch wide
# enough (512+ blocks) that the keys are not split
SKIPS = [(8, 16, 8, 512, 512, 64, True, None),
         (1, 2, 1, 384, 256, 64, True, None),
         (1, 2, 1, 384, 320, 64, True, None),
         (1, 4, 2, 384, 352, 80, True, None),
         (1, 4, 2, 512, 512, 64, True, 64),
         (1, 2, 2, 512, 512, 128, False, 64),
         (2, 2, 2, 1, 1000, 64, True, None),
         (2, 8, 2, 1, 1000, 64, True, None),
         (2, 16, 2, 1, 1000, 128, True, None),
         (3, 8, 1, 2, 777, 64, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SKIPS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_skips_masked_chunks_and_splits_keys(case, dtype):
    """The kernels' chunk ranges and key splits against the plain
    version run with the same tiles and splits, and against the plain
    version without them; rows that see no key are the mean of V."""
    _card()
    b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v = (_randn(s, *shape, dtype=dtype) for s, shape in
               enumerate([(b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]))
    which = fa.variant(q.dtype, k.dtype, v.dtype, d)
    assert which == ("wgmma" if dtype == torch.bfloat16 else "ffma")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_q, _, splits = fa.launch_plan(b, hkv, hq // hkv, sq, sk, which, sms)
    assert (splits == 1) == (b == 8)
    counts = (fa.flash_attention.wgmma_launches,
              fa.flash_attention.ffma_launches,
              fa.flash_attention.combine_launches)
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=sq, block_k=sk)
    torch.cuda.synchronize()
    ran = (fa.flash_attention.wgmma_launches - counts[0],
           fa.flash_attention.ffma_launches - counts[1],
           fa.flash_attention.combine_launches - counts[2])
    assert ran == (int(which == "wgmma"), int(which == "ffma"),
                   int(splits > 1))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    for kw in ({"skip_masked": True, "splits": splits, "tile_q": tile_q,
                "block_k": fa.BC}, {"block_k": sk}):
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, **kw)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
    if causal and sq > sk:
        mean = v.float().mean(2).repeat_interleave(hq // hkv, 1)
        torch.testing.assert_close(
            out[:, :, :sq - sk].float(),
            mean[:, :, None].expand(b, hq, sq - sk, d), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_a_view_off_a_16_byte_boundary(dtype):
    """A view one element past a 16-byte boundary is copied before TMA
    reads it: the result equals the aligned inputs' bit for bit."""
    _card()
    q, k, v = _randn(0, 1, 4, 128, 64, dtype=dtype), \
        _randn(1, 1, 2, 192, 64, dtype=dtype), \
        _randn(2, 1, 2, 192, 64, dtype=dtype)
    views = [_offset_view(t) for t in (q, k, v)]
    assert all(t.data_ptr() % 16 for t in views)
    got = fa.flash_attention(*views, block_q=64, block_k=64)
    want = fa.flash_attention(q, k, v, block_q=64, block_k=64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_rows_without_a_key_are_the_mean_of_v():
    _card()
    q, k, v = _randn(0, 1, 2, 8, 16), _randn(1, 1, 1, 4, 16), \
        _randn(2, 1, 1, 4, 16)
    out = ops.attention(q, k, v, block_q=4, block_k=4)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[0, :, :4], v[0, 0].mean(0).expand(2, 4, 16),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_auto_tile_and_ops_on_the_card():
    _card()
    q, k, v = _randn(0, 1, 4, 256, 64), _randn(1, 1, 2, 256, 64), \
        _randn(2, 1, 2, 256, 64)
    ops.clear_plan_memo()
    blocks, _ = ops.resolve_plan("attention", 256, 256, 64, device=q.device)
    assert blocks == (128, 128)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, auto_tile=True)
    assert ops.attention(q, k, v).is_cuda
    assert fa.flash_attention.launches == before + 2
    torch.testing.assert_close(out, ops.attention(q, k, v, use_kernel=False),
                               rtol=2e-4, atol=2e-4)


def _ssd_inputs(b, s, h, dh, n, dtype=torch.float32):
    rng = np.random.RandomState(s + n)
    x = rng.randn(b, s, h, dh)
    dt = np.log1p(np.exp(rng.randn(b, s, h))) * 0.1
    A = -np.log1p(np.exp(rng.randn(h))) - 0.1
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    return [torch.as_tensor(t.astype(np.float32)).cuda().to(
        torch.float32 if t is A else dtype) for t in (x, dt, A, B, C)]


# (b, s, h, dh, n, chunk): the reference's shapes, chunks of two and four
# 64-row tiles at mamba2-370m's state width, head dims and states that are not
# whole 16-byte rows in bfloat16 (the kernels' plain-load path), and 8
# chunks of 2 batch rows, so that the carry and the scores' sharing show
SSD = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 32, 1, 8, 4, 32),
       (1, 256, 2, 64, 128, 128), (1, 512, 2, 64, 128, 256),
       (2, 96, 3, 24, 12, 48), (2, 512, 3, 64, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(case, dtype):
    """Every pass launched once per call, two calls bitwise equal, the
    result within tolerance of the plain version."""
    _card()
    b, s, h, dh, n, chunk = case
    x, dt, A, B, C = _ssd_inputs(b, s, h, dh, n, dtype)
    before = ssd.ssd_scan.launches
    passes = dict(ssd.ssd_scan.pass_launches)
    y = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    assert all(ssd.ssd_scan.pass_launches[p] == passes[p] + 1
               for p in ssd.PASSES)
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, ssd.ssd_scan(x, dt, A, B, C, chunk=chunk))
    want = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk).float()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(y.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_scan_bfloat16_is_float32_on_widened_inputs(case):
    """Every product is float32 FFMA in both types: the bfloat16 kernel
    gives the float32 kernel's result on the widened inputs, rounded."""
    _card()
    b, s, h, dh, n, chunk = case
    x, dt, A, B, C = _ssd_inputs(b, s, h, dh, n, torch.bfloat16)
    y = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y32 = ssd.ssd_scan(x.float(), dt.float(), A, B.float(), C.float(),
                       chunk=chunk)
    assert torch.equal(y, y32.bfloat16())


@pytest.mark.cuda
def test_ssd_auto_tile_and_ops_on_the_card():
    _card()
    x, dt, A, B, C = _ssd_inputs(1, 128, 2, 16, 8)
    before = ssd.ssd_scan.launches
    y = ssd.ssd_scan(x, dt, A, B, C, auto_tile=True)
    assert ops.ssd(x, dt, A, B, C, chunk=32).is_cuda
    assert ssd.ssd_scan.launches == before + 2
    want = ops.ssd(x, dt, A, B, C, use_kernel=False)
    torch.testing.assert_close(y, want, rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_lm_kernels_refuse_what_they_cannot_take():
    _card()
    q = _randn(0, 1, 2, 64, 144)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    x, dt, A, B, C = _ssd_inputs(1, 16384, 2, 16, 8)
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=16384)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     B, C, chunk=64)


def paged_case(b, hkv, group, d, ps, npm, layout, dtype, seed=0,
               device="cuda"):
    """Inputs of one paged-decode step: shuffled, disjoint page tables
    over a pool with spare pages, lengths crossing page boundaries and
    reaching the last page of the table.  Shared with the CPU tests."""
    rng = np.random.RandomState(seed)
    n_phys = 1 + b * npm + 3
    heads = 2 * hkv if layout == "fused" else hkv
    pools = tuple(torch.as_tensor(rng.randn(n_phys, ps, heads, d)
                                  .astype(np.float32)).to(device, dtype)
                  for _ in range(1 if layout == "fused" else 2))
    table = rng.permutation(np.arange(1, n_phys))[:b * npm]
    table = torch.as_tensor(table.reshape(b, npm).astype(np.int32),
                            device=device)
    top = npm * ps - 1
    lens = np.minimum(np.array([top, ps, 0, 2 * ps + 1, ps - 1] * b)[:b],
                      top)
    lens = torch.as_tensor(lens.astype(np.int32), device=device)
    q = torch.as_tensor(rng.randn(b, hkv, group, d).astype(np.float32),
                        device=device).to(dtype)
    k, v = (torch.as_tensor(rng.randn(b, hkv, d).astype(np.float32),
                            device=device) for _ in range(2))
    return q, k, v, pools, table, lens


# (b, hkv, group, d, ps, npm): granite's widths (group 4, head dim 64) at
# page sizes 8 and 64, MQA, a group of 12 over 3 warps' rows, head dims
# 16 and 128, a page size that does not divide the 64-key chunk
PAGED = [(4, 8, 4, 64, 8, 16), (3, 2, 4, 64, 64, 3), (2, 1, 8, 32, 16, 5),
         (5, 2, 12, 16, 4, 9), (2, 2, 2, 128, 32, 4), (3, 2, 4, 64, 24, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED, ids=str)
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(case, layout, dtype):
    _card()
    b, hkv, group, d, ps, npm = case
    q, k, v, pools, table, lens = paged_case(*case, layout, dtype)
    plain_pools = tuple(p.clone() for p in pools)
    kern = cc.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                 head_dim=d, page_size=ps, n_pages_max=npm,
                                 layout=layout)
    before = cc.lower_paged_decode.launches
    out, new_pools = kern(q, k, v, pools, table, lens)
    torch.cuda.synchronize()
    assert cc.lower_paged_decode.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert all(a is b_ for a, b_ in zip(new_pools, pools))   # in place
    want = cc.paged_decode_plain(q, k, v, plain_pools, table, lens,
                                 layout=layout)
    for got, exp in zip(pools, plain_pools):
        assert torch.equal(got, exp)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def _paged_launches():
    f = cc.lower_paged_decode
    return f.launches, f.attend_launches, f.combine_launches


# (b, hkv, group, d, ps, npm): one split (272 blocks fill the card and no
# request spans more than 16 chunks), and many (a few long requests)
SPLIT_SHAPES = [(34, 8, 4, 64, 8, 32), (3, 2, 4, 64, 8, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_SHAPES, ids=str)
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_splits_and_parked_requests(case, layout, dtype):
    """Ragged lengths and parked requests (every table entry page 0,
    length 0, as serving parks a free slot): the parts the kernel splits
    a request into merge to the plain version's output, the pools equal
    the plain version's bitwise but for page 0's slot 0, every element of
    which is one parked request's (their blocks write it at once), and
    the attend and combine kernels each launch once (the combine only
    when there is more than one split)."""
    _card()
    b, hkv, group, d, ps, npm = case
    q, k, v, pools, table, lens = paged_case(*case, layout, dtype, seed=3)
    rng = np.random.RandomState(4)
    lens = torch.as_tensor(rng.randint(0, npm * ps, b).astype(np.int32),
                           device="cuda")
    parked = torch.arange(b, device="cuda") % 3 == 1
    table[parked] = 0
    lens[parked] = 0
    plain_pools = tuple(p.clone() for p in pools)
    splits = cc.paged_splits(b, hkv, npm, ps, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert (splits == 1) == (case == SPLIT_SHAPES[0])
    kern = cc.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                 head_dim=d, page_size=ps, n_pages_max=npm,
                                 layout=layout)
    before = _paged_launches()
    out, _ = kern(q, k, v, pools, table, lens)
    torch.cuda.synchronize()
    after = _paged_launches()
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, int(splits > 1)]
    unsplit = cc.paged_decode_plain(q, k, v, plain_pools, table, lens,
                                    layout=layout)
    want = cc.paged_decode_plain(q, k, v, tuple(p.clone() for p in pools),
                                 table, lens, layout=layout, splits=splits)
    live = ~parked                 # a parked row reads its own new K and V
    torch.testing.assert_close(out[live], want[live], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out[live], unsplit[live], rtol=2e-4,
                               atol=2e-4)
    for got, exp in zip(pools, plain_pools):
        assert torch.equal(got[1:], exp[1:])
        assert torch.equal(got[0, 1:], exp[0, 1:])
    ki, vi, _, mul, k_off, v_off = cc._pd_heads(layout, hkv)
    for pool, off, new in ((pools[ki], k_off, k), (pools[vi], v_off, v)):
        heads = torch.arange(hkv, device="cuda") * mul + off
        rows = new[parked].to(dtype)        # (parked, hkv, d)
        assert bool((pool[0, 0, heads][None] == rows).any(0).all())


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_what_it_cannot_take():
    _card()
    q, k, v, pools, table, lens = paged_case(2, 2, 4, 144, 8, 4, "split",
                                             torch.float32)
    kern = cc.lower_paged_decode(batch=2, kv_heads=2, group=4, head_dim=144,
                                 page_size=8, n_pages_max=4)
    with pytest.raises(ValueError, match="head dim"):
        kern(q, k, v, pools, table, lens)
    q, k, v, pools, table, lens = paged_case(2, 2, 4, 64, 8, 4, "split",
                                             torch.float16)
    kern = cc.lower_paged_decode(batch=2, kv_heads=2, group=4, head_dim=64,
                                 page_size=8, n_pages_max=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kern(q, k, v, pools, table, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "fused"])
def test_paged_serving_on_the_card_matches_the_dense_oracle(layout):
    """Continuous serving of granite-3-2b SMOKE through the kernel,
    token-identical to the port's dense ``decode_step`` on the card."""
    _card()
    from repro_torch.launch import serve, steps
    from repro_torch.configs import get_config
    from repro_torch.models import model

    lens, gen, slots = (3, 5, 9, 4), 3, 2
    before = cc.lower_paged_decode.launches
    toks, stats = serve.serve_continuous("granite-3-2b", True, slots, gen,
                                         prompt_lens=lens, layout=layout)
    cfg = get_config("granite-3-2b", smoke=True)
    assert stats["certified"] and stats["use_pallas"]
    assert cc.lower_paged_decode.launches - before \
        == cfg.n_layers * (stats["steps"] + 5 + 4 - 1)
    params = model.init_params(cfg, 0, "cuda")
    pool = np.random.RandomState(0).randint(0, cfg.vocab, (len(lens),
                                                           max(lens)))
    ps = stats["page_size"]
    cmax = -(-(max(lens) + gen) // ps) * ps
    step = steps.make_serve_step(cfg)
    for r, ln in enumerate(lens):
        cache = model.init_cache(cfg, 1, cmax, device="cuda")
        nxt, want = None, []
        for i in range(ln + gen):
            tok = (torch.as_tensor(pool[r:r + 1, i:i + 1], dtype=torch.int32,
                                   device="cuda") if i < ln
                   else nxt.reshape(1, 1))
            nxt, cache = step(params, cache, tok, i)
            if i >= ln:
                want.append(int(nxt[0]))
        assert list(toks[r]) == want, f"request {r} diverged"


@pytest.mark.cuda
def test_kernels_take_the_reference_kernels_input_types_on_the_card():
    """The wrappers cast as the reference's kernels cast inside: the
    result has the reference's type and the plain version's value."""
    _card()
    x, y = _randn(0, 64, 64), _randn(1, 64, 64)
    got = mm.matmul(x.half(), y.half(), block_m=32, block_n=32, block_k=32)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), x.half().float()
                               @ y.half().float(), rtol=2e-3, atol=2e-3)
    q, k, v = _randn(2, 1, 4, 64, 32), _randn(3, 1, 2, 64, 32), \
        _randn(4, 1, 2, 64, 32)
    out = fa.flash_attention(q.half(), k.half(), v.half(), block_q=64,
                             block_k=64)
    assert out.dtype == torch.float16
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(
        q.half().float(), k.half().float(), v.half().float(), block_k=64),
        rtol=2e-3, atol=2e-3)
    xs, dt, A, B, C = _ssd_inputs(1, 64, 2, 16, 8)
    bf = [t.bfloat16() for t in (xs, B, C)]
    y = ssd.ssd_scan(bf[0], dt, A, bf[1], bf[2], chunk=32)
    assert y.dtype == torch.bfloat16
    want = ssd.ssd_scan_plain(bf[0].float(), dt, A, bf[1].float(),
                              bf[2].float(), chunk=32)
    torch.testing.assert_close(y.float(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))
    keys = torch.randint(0, 8, (256,), device="cuda")        # int64
    vals = _randn(5, 256, 4).half()
    torch.testing.assert_close(gbf.groupby_fold(keys, vals, 8, block_t=64),
                               gbf.groupby_fold_plain(keys.int(),
                                                      vals.float(), 8),
                               rtol=1e-5, atol=1e-5)
    xv, wv = _randn(6, 1024).half(), _randn(7, 1024).half()
    torch.testing.assert_close(fr.filter_reduce(xv, wv, -0.5, 0.8,
                                                block_t=256),
                               fr.filter_reduce_plain(xv.float(), wv.float(),
                                                      -0.5, 0.8),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------- the tuning runtime
@pytest.mark.cuda
def test_measured_explore_certifies_on_the_card_then_hits(tmp_path):
    """``explore(measure="top_k")`` on the card: candidates built first
    (nvcc outside the timed window), timed on the tiled-Map template,
    the winner certified against the eager oracle on the card; the
    second call is a cache hit that builds and lowers nothing."""
    _card()
    from repro_torch.core import dse, resilience, telemetry

    resilience.LOG.reset()
    p = an.outerprod(1024, 2048)[0]
    stores = dict(cache=str(tmp_path / "dse.json"),
                  timing_db=str(tmp_path / "timing.json"),
                  policy=resilience.Policy(timeout_s=300, retries=0))
    telemetry.enable()
    try:
        before = cc.tiled_map.launches
        plan = dse.explore(p, measure="top_k", **stores)
        assert plan.measured and plan.timed >= 2
        assert cc.tiled_map.launches > before
        cert = dse.explain_dict(plan)["provenance"]["certification"]
        assert cert and cert[-1]["ok"] and "cuda-vs-oracle" \
            in cert[-1]["reason"]
        assert resilience.LOG.events() == []
        builds, spans = build.compile_all.builds, len(telemetry.span_log())
        again = dse.explore(p, measure="top_k", **stores)
        assert again.cached and again.sizes == plan.sizes
        assert build.compile_all.builds == builds
        assert not [s for s in telemetry.span_log()[spans:]
                    if s["name"].startswith("codegen.")]
    finally:
        telemetry.reset()


STICKY_PROBE = r'''
import ctypes, sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.core import codegen_cuda as cc, resilience
from repro_torch.device import StickyCudaError
from repro_torch.kernels import build
lib = cc._gemm_library(64, 64, 64, 2)
stream = torch.cuda.current_stream().cuda_stream
bad = ctypes.c_void_p(16)

def launch():
    build.check(lib, lib.gemm_launch(bad, bad, bad, 256, 256, 256, stream),
                "planted launch")
    torch.cuda.synchronize()

try:
    resilience.call_guarded(launch, stage="time", key="planted",
                            policy=resilience.Policy(timeout_s=60))
except StickyCudaError as e:
    print("sticky", resilience.classify(e.__cause__ or e))
except resilience.CandidateFailure as e:
    print("quarantined", e.kind)
try:
    build.check(lib, lib.gemm_launch(bad, bad, bad, 256, 256, 256, stream),
                "after")
except StickyCudaError:
    print("check sticky")
print("events", len(resilience.LOG.events()))
'''


@pytest.mark.cuda
def test_a_planted_illegal_address_is_sticky_not_quarantined(tmp_path):
    """A kernel fed an illegal address poisons the context (run in a
    throwaway process): ``call_guarded`` raises ``StickyCudaError``
    instead of quarantining the candidate, and ``build.check`` raises
    it for every launch after."""
    _card()
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    script = tmp_path / "probe.py"
    script.write_text(STICKY_PROBE)
    out = subprocess.run([sys.executable, str(script), src],
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.split("\n")
    assert "sticky cuda-sticky" in lines, out.stdout + out.stderr
    assert "check sticky" in lines and "events 0" in lines


@pytest.mark.cuda
def test_measure_excludes_its_warmup_on_the_card():
    """The first call (here a 0.2 s sleep before its launch) is warm-up,
    excluded; every timed call is fenced by ``torch.cuda.synchronize``,
    so it covers the kernel, not its issue."""
    _card()
    import time
    from repro_torch.core import measure

    x = torch.randn(4096, 4096, device="cuda")
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.2)
        return x @ x

    m = measure.measure(fn, warmup=1, repeat=5, device="cuda")
    assert len(calls) == 6 and m.max_s < 0.1
    assert m.device == measure.device_kind("cuda") and not m.interpret
    # fenced: the median covers a 4096^3 FFMA product (~2 ms at peak)
    assert m.median_s > 1e-3
