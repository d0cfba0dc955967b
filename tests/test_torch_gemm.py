"""The port's tiled GEMM (``codegen_cuda.lower`` of the Table 3 tiled IR)
against the JAX package's ``lower_tiled_gemm`` (Pallas in interpret
mode) on the same seeded inputs, on the CPU through the kernel's plain
version, and the template dispatch.  float32 rtol/atol 2e-3.  The
template's shape at a plan's tile (``gemm_layout``: micro-tile, threads,
shared bytes) against what ``memory.plan_memory`` charges the tile.
"""
import numpy as np
import pytest
import torch

from repro.core.codegen_pallas import lower as jlower
from repro.core.strip_mine import tile as jtile
from repro.patterns import analytics as jan

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import ir, memory
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

TOL = dict(rtol=2e-3, atol=2e-3)
SHAPES = [(128, 128, 128, 64, 64, 64), (128, 256, 192, 32, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_lowered_gemm_matches_jax(shape):
    jp, jsizes, make_inputs, _ = jan.gemm(*shape)
    tp, tsizes, _, ref = an.gemm(*shape)
    inp = make_inputs()
    want = np.asarray(jlower(jtile(jp, jsizes))(**inp))
    call = cc.lower(tile(tp, tsizes), device="cpu")
    got = call(**inp)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), ref(inp), **TOL)
    m, n, k, bm, bn, bk = shape
    assert call.tile_plan == {"gemm": (bm, bn), "gemm_k": (bk,), "depth": 2}


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_lower_carries_the_plans_depth(depth):
    """``lower(..., depth=d)`` instantiates the template at d and runs
    the same product as the reference."""
    shape = (128, 128, 256, 64, 64, 32)
    jp, jsizes, make_inputs, _ = jan.gemm(*shape)
    tp, tsizes, _, _ = an.gemm(*shape)
    inp = make_inputs()
    call = cc.lower(tile(tp, tsizes), device="cpu", depth=depth)
    assert call.tile_plan == {"gemm": (64, 64), "gemm_k": (32,),
                              "depth": depth}
    assert call.source == cc.gemm_source(64, 64, 32, depth)
    assert f"tgemm::launch<64, 64, 32, {depth}>" in call.source
    want = np.asarray(jlower(jtile(jp, jsizes))(**inp))
    np.testing.assert_allclose(call(**inp).numpy(), want, **TOL)


# (bm, bn, bk, depth) -> (micro-tile, threads): 8x8 where the tile keeps
# at least 128 threads, else 8x4, else 4x4 (also below 128 threads)
LAYOUTS = {(64, 64, 64, 2): (8, 4, 128), (128, 128, 32, 3): (8, 8, 256),
           (128, 64, 16, 4): (8, 8, 128), (64, 32, 32, 2): (4, 4, 128),
           (32, 32, 32, 2): (4, 4, 64), (128, 256, 16, 2): (8, 8, 512),
           (96, 64, 64, 3): (8, 4, 192)}


@pytest.mark.parametrize("tile_", sorted(LAYOUTS), ids=str)
def test_gemm_layout_charges_what_plan_memory_charges(tile_):
    """The template's shared bytes are ``plan_memory``'s charge for the
    two streamed tiles at the same depth, plus the x rows' padding
    (GEMM_XPAD words a row in each slot, which spreads the rows a warp
    reads over the banks)."""
    bm, bn, bk, depth = tile_
    lay = cc.gemm_layout(bm, bn, bk, depth)
    assert (lay.tm, lay.tn, lay.threads) == LAYOUTS[tile_]
    p, sizes, _, _ = an.gemm(2 * bm, 2 * bn, 4 * bk, bm, bn, bk)
    tiled = tile(p, sizes)
    assert cc.match_tiled_gemm(tiled)
    charged = memory.plan_memory(tiled, depth=depth).total_bytes
    assert charged == depth * (bm * bk + bk * bn) * 4
    assert lay.pad_bytes == depth * bm * cc.GEMM_XPAD * 4
    assert lay.smem_bytes == charged + lay.pad_bytes


def test_plain_gemm_is_the_product():
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.randn(64, 96).astype(np.float32))
    y = torch.as_tensor(rng.randn(96, 32).astype(np.float32))
    got = cc.tiled_gemm(x, y, bm=32, bn=32, bk=32)
    np.testing.assert_allclose(got.numpy(), x.numpy().astype(np.float64)
                               @ y.numpy().astype(np.float64), **TOL)
    with pytest.raises(ValueError, match="must divide"):
        cc.tiled_gemm(x, y, bm=48, bn=32, bk=32)
    with pytest.raises(ValueError, match="depth"):
        cc.tiled_gemm(x, y, bm=32, bn=32, bk=32, depth=1)


def test_only_the_gemm_template_is_ported():
    """Template selection beside the GEMM: the tiled outer product (a
    write-once Map) now lowers to the tiled-Map template, not the GEMM;
    a strided fold still has no template."""
    n = 64
    x = ir.Tensor("x", (n,))
    outer = ir.Map(domain=(n, n),
                   reads=(ir.Access(x, lambda i, j: (i,), (1,)),
                          ir.Access(x, lambda i, j: (j,), (1,))),
                   fn=lambda s, a, b: a * b, name="outer")
    call = cc.lower(tile(outer, {"outer": (32, 32)}), device="cpu")
    assert call.kernel.spec.kind == "map" and call.kernel.spec.steps == 4
    xs = np.random.RandomState(0).randn(n).astype(np.float32)
    np.testing.assert_array_equal(call(x=xs).numpy(), np.outer(xs, xs))
    p, sizes, _, _ = an.sumrows()
    with pytest.raises(NotImplementedError, match="no CUDA template"):
        cc.lower(tile(p, sizes), device="cpu")


def test_gemm_source_instantiates_the_tile():
    src = cc.gemm_source(64, 64, 32, 3)
    assert '#include "tiled_gemm.cuh"' in src
    assert "tgemm::launch<64, 64, 32, 3>" in src
    assert "tgemm::layout<64, 64, 32, 3>" in src
    assert src == cc.gemm_source(64, 64, 32, 3)
    assert src != cc.gemm_source(64, 64, 32, 2)
