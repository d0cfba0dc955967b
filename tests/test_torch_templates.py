"""The port's single-pattern templates (``codegen_cuda.lower`` of a tiled
pattern, and ``lower_auto``) on the CPU -- each kernel's plain version,
which reads the inputs at the offsets the kernel is generated with --
against the JAX package's Pallas templates in interpret mode, on the
same seeded numpy inputs, at sizes with several grid steps.

Tolerances: tiled Map and FlatMap bitwise (one IEEE operation per
output word in both packages; count exact, the buffer's tail zero);
tiled GroupByFold float32 rtol/atol 2e-3 (the sums are taken in another
order).  Also the generated sources and the SUITE programs against the
JAX package's eager executor.
"""
import dataclasses
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen_jax as jex
from repro.core import ir as jir
from repro.core.codegen_pallas import lower as jlower
from repro.core.codegen_pallas import lower_auto as jlower_auto
from repro.core.strip_mine import tile as jtile
from repro.patterns import analytics as jan

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import codegen_torch as tex
from repro_torch.core import cost
from repro_torch.core.memory import plan_memory
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

sys.path.insert(0, os.path.dirname(__file__))
from test_core_transforms import mk_filter, mk_hist  # noqa: E402
from test_torch_cuda import (column_pairs_program, filter_program,  # noqa: E402
                             hist_program, pairs_program, two_way_program)

TOL = dict(rtol=2e-3, atol=2e-3)


# JAX twins of the port's test programs (test_torch_cuda.py)
def jpairs(n):
    x = jir.Tensor("x", (2 * n,))
    return jir.Map(
        domain=(n,), elem_shape=(2,),
        reads=(jir.Access(x, lambda i: (2 * i,), (2,)),),
        fn=lambda s, w: jnp.stack([w[0] + w[1], w[0] * w[1]]), name="pairs")


def jcolumn_pairs(m, n):
    x = jir.Tensor("x", (2 * m, n))
    return jir.Map(
        domain=(m, n),
        reads=(jir.Access(x, lambda i, j: (2 * i, j), (2, 1)),),
        fn=lambda s, w: w[0] - w[1], name="cols")


def jtwo_way(n):
    x = jir.Tensor("x", (n,))

    def fn(s, e):
        count = jnp.where(e > 0.5, 2, jnp.where(e > -0.5, 1, 0))
        return jnp.stack([e, -e]), count.astype(jnp.int32)

    return jir.FlatMap(domain=(n,), max_per_iter=2, reads=(jir.elem(x),),
                       fn=fn, name="two")


def jhist_unclipped(n, k):
    x = jir.Tensor("x", (n,))
    return jir.GroupByFold(
        domain=(n,), num_keys=k, init=lambda: jnp.zeros(k),
        reads=(jir.elem(x),),
        fn=lambda s, e: (e.astype(jnp.int32), jnp.float32(1.0)),
        combine=lambda a, b: a + b, name="h")


def _inputs(p, seed):
    rng = np.random.RandomState(seed)
    return {t.name: rng.randn(*t.shape).astype(np.float32)
            for t in jir.inputs_of(p)}


# -------------------------------------------------------- tiled Map
MAPS = {
    "outerprod": (lambda: jan.outerprod(256, 192)[0],
                  lambda: an.outerprod(256, 192)[0], {"outer": (64, 64)}),
    "pairs": (lambda: jpairs(1024), lambda: pairs_program(1024),
              {"pairs": (256,)}),
    "columns": (lambda: jcolumn_pairs(64, 96),
                lambda: column_pairs_program(64, 96), {"cols": (16, 32)}),
}


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_tiled_map_matches_the_reference_bitwise(name, depth):
    jbuild, tbuild, sizes = MAPS[name]
    inp = _inputs(jbuild(), seed=1)
    want = np.asarray(jlower(jtile(jbuild(), sizes))(**inp))
    call = cc.lower(tile(tbuild(), sizes), device="cpu", depth=depth)
    assert call.kernel.spec.kind == "map" and call.kernel.spec.steps > 1
    got = call(**inp)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tiled_map_refuses_a_copy_that_is_not_block_aligned():
    """The reference's BlockSpecs address whole blocks; so do the port's
    tile copies (codegen_pallas._block_index_map)."""
    p = tile(pairs_program(64), {"pairs": (16,)})
    (tc,) = p.loads
    shifted = dataclasses.replace(tc, index_map=lambda g: (32 * g + 4,))
    bad = dataclasses.replace(p, tile_loads=(shifted,))
    with pytest.raises(ValueError, match="block-aligned"):
        cc.lower(bad, device="cpu")


# ------------------------------------------------- tiled GroupByFold
def test_tiled_gda_matches_the_reference():
    jp, js, make_inputs, _ = jan.gda()
    tp, ts, _, reference = an.gda()
    inp = make_inputs()
    want = np.asarray(jlower(jtile(jp, js))(**inp))
    call = cc.lower(tile(tp, ts), device="cpu")
    assert [t.kind for t in call.kernel.spec.terminals] == ["cam"]
    got = call(**inp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, reference(inp), **TOL)


@pytest.mark.parametrize("clip", [True, False])
def test_tiled_histogram_matches_the_reference(clip):
    n, k = 256, 8
    xs = np.random.RandomState(3).randint(-3, k + 3, n).astype(np.float32)
    xs[:4] = [-1.0, float(k), -0.5, k + 0.5]    # -0.5 truncates to key 0
    jp = mk_hist(n, k) if clip else jhist_unclipped(n, k)
    want = np.asarray(jlower(jtile(jp, {"h": (32,)}))(x=xs))
    got = cc.lower(tile(hist_program(n, k, clip), {"h": (32,)}),
                   device="cpu")(x=xs).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    keys = xs.astype(np.int32)
    keys = np.clip(keys, 0, k - 1) if clip \
        else keys[(keys >= 0) & (keys < k)]
    np.testing.assert_array_equal(got, np.bincount(keys, minlength=k))


# ---------------------------------------------------- tiled FlatMap
FLATMAPS = {
    "filter": (mk_filter, filter_program),
    "two_way": (jtwo_way, two_way_program),
}


@pytest.mark.parametrize("n,b", [(64, 16), (1000, 40)])
@pytest.mark.parametrize("name", sorted(FLATMAPS))
def test_tiled_flatmap_matches_the_reference_bitwise(name, n, b):
    jbuild, tbuild = FLATMAPS[name]
    xs = np.random.RandomState(n).randn(n).astype(np.float32)
    jbuf, jcount = jlower(jtile(jbuild(n), {jbuild(n).name: (b,)}))(x=xs)
    p = tbuild(n)
    buf, count = cc.lower(tile(p, {p.name: (b,)}), device="cpu")(x=xs)
    assert count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if name == "filter":
        want = xs[xs > 0]
    else:
        pairs = [(e, -e) if e > 0.5 else (e,) if e > -0.5 else () for e in xs]
        want = np.array([v for t in pairs for v in t], np.float32)
    assert int(count) == want.size
    np.testing.assert_array_equal(buf.numpy()[:want.size], want)
    assert not buf[want.size:].any()


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("name", sorted(FLATMAPS))
def test_eager_oracle_runs_a_flatmap_as_the_reference(name, tiled):
    """``codegen_torch.execute`` on a FlatMap, untiled and tiled, against
    ``codegen_jax.execute``: the buffer bitwise, the count exact, the
    tail zero."""
    jbuild, tbuild = FLATMAPS[name]
    n, b = 1000, 40
    xs = np.random.RandomState(n).randn(n).astype(np.float32)
    jp, tp = jbuild(n), tbuild(n)
    if tiled:
        jp, tp = jtile(jp, {jp.name: (b,)}), tile(tp, {tp.name: (b,)})
    jbuf, jcount = jex.execute(jp, {"x": xs})
    buf, count = tex.execute(tp, {"x": xs}, device="cpu")
    assert count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(jcount)
    assert tuple(buf.shape) == tp.shape == (n * tbuild(n).max_per_iter,)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert not buf[int(count):].any()


# -------------------------------------------------------- lower_auto
def _plan_fields(p):
    return (p.sizes, p.depths, p.traffic_words, p.vmem_bytes,
            p.modeled_seconds, p.explored, p.pruned, p.thinned)


AUTO = {
    "outerprod": (lambda: jan.outerprod(512, 256)[0],
                  lambda: an.outerprod(512, 256)[0]),
    "gda": (lambda: jan.gda(n=2048)[0], lambda: an.gda(n=2048)[0]),
    "filter": (lambda: mk_filter(4096), lambda: filter_program(4096)),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_lower_auto_matches_the_reference(name):
    jbuild, tbuild = AUTO[name]
    inp = _inputs(jbuild(), seed=7)
    jkern = jlower_auto(jbuild(), cache=False)
    kern = cc.lower_auto(tbuild(), device="cpu", tier=cost.TPU)
    assert _plan_fields(kern.tile_plan) == _plan_fields(jkern.tile_plan)
    want, got = jkern(**inp), kern(**inp)
    if name == "filter":
        assert int(got[1]) == int(want[1])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    elif name == "outerprod":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------ sources, executor
@pytest.mark.parametrize("name", sorted(MAPS) + sorted(FLATMAPS))
def test_generated_source_is_deterministic_and_has_the_body(name):
    build = MAPS[name][1] if name in MAPS else FLATMAPS[name][1]
    sizes = MAPS[name][2] if name in MAPS else None

    def source():
        p = build() if name in MAPS else build(1024)
        spec = cc.tiled_spec(tile(p, sizes or {p.name: (256,)}), depth=3)
        gen = cc.map_source if spec.kind == "map" else cc.flatmap_source
        return gen(spec), p

    src, p = source()
    assert src == source()[0]
    assert "constexpr int DEPTH = 3;" in src
    template = "tiled_map.cuh" if name in MAPS else "tiled_flatmap.cuh"
    assert f'#include "{template}"' in src
    for line in p.cuda.splitlines():
        assert line.strip() in src, line
    if name in FLATMAPS:
        assert "int& count" in src


@pytest.mark.parametrize("b", [256, 250])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("name", sorted(FLATMAPS))
def test_flatmap_source_is_one_cooperative_pass(name, depth, b):
    """The FlatMap's source at depths 2 and 3: deterministic; one
    ``__global__`` tile kernel (no count or scan kernel), launched
    cooperatively; 16-byte copyable tiles (b = 256) through the
    ``cp.async`` ring, the others (b = 250) copied synchronously; no
    atomics; its shared bytes the plan's charge plus the counted scan
    scratch."""
    def tiled():
        p = FLATMAPS[name][1](4 * b)
        return tile(p, {p.name: (b,)})

    def spec():
        return cc.tiled_spec(tiled(), depth=depth)

    s = spec()
    src = cc.flatmap_source(s)
    assert src == cc.flatmap_source(spec())
    assert len(re.findall(r"\b__global__\b", src)) == 1
    assert "flatmap_kernel(" in src
    for gone in ("scan_kernel", "count_kernel", "write_kernel", "<<<"):
        assert gone not in src
    assert "gflags::launch(flatmap_kernel" in src
    assert "tfm::look_back(" in src and "tfm::publish_count(" in src
    assert not re.search(r"atomic|\bred\.", src)
    vec = any(ld.vec4 and ld.slots > 1 for ld in s.loads)
    assert vec == (b == 256)
    assert ("fdag::copy_async(" in src) == vec
    assert ("tcopy::copy_scalar(" in src) == (not vec)
    assert "hop::cp_async_wait<DEPTH - 2>();" in src
    assert s.onchip_bytes == plan_memory(tiled(), depth=depth).total_bytes
    assert s.scan_bytes == cc.FLATMAP_SCAN_BYTES
    assert s.smem_bytes == s.onchip_bytes + s.scan_bytes
    assert f"constexpr int SMEM_BYTES = {s.smem_bytes};" in src
    assert f"constexpr int CHARGE_BYTES = {s.onchip_bytes};" in src


def test_a_pattern_without_a_cuda_body_has_no_source():
    p = an.outerprod(128, 128)[0]
    bare = dataclasses.replace(p, cuda=None)
    call = cc.lower(tile(bare, {"outer": (64, 64)}), device="cpu")
    with pytest.raises(NotImplementedError, match="no CUDA body"):
        call.kernel.source


def test_inputs_off_a_16_byte_boundary_are_refused_before_a_launch():
    """The kernels read 16-byte pieces, so the launch check refuses a
    view one word past a boundary (``test_torch_cuda.py`` launches one
    through the lowered call, which copies it); the CPU's plain version
    takes it as it is."""
    x = torch.as_tensor(np.random.RandomState(5).randn(65).astype(np.float32))
    cc._aligned([("x", x[:64])])
    with pytest.raises(ValueError, match="16-byte"):
        cc._aligned([("x", x[1:])])
    call = cc.lower(tile(filter_program(64), {"f": (16,)}), device="cpu")
    (buf, count), (want_buf, want_count) = call(x=x[1:]), call(x=x[1:].clone())
    assert torch.equal(buf, want_buf) and int(count) == int(want_count)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("name", sorted(an.SUITE))
def test_suite_programs_match_the_jax_executor(name, tiled):
    jp, jsizes, make_inputs, jref = jan.SUITE[name]()
    tp, tsizes, t_inputs, ref = an.SUITE[name]()
    inp = make_inputs()
    assert tsizes == jsizes
    assert all(np.array_equal(inp[k], v) for k, v in t_inputs().items())
    if tiled:
        jp, tp = jtile(jp, jsizes), tile(tp, tsizes)
    got = tex.execute(tp, inp, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jex.execute(jp, inp)), **TOL)
    np.testing.assert_allclose(got, ref(inp), **TOL)
    np.testing.assert_allclose(ref(inp), np.asarray(jref(inp)), **TOL)
