"""The rest of the compiler surface, held against the reference's own
tests called on both packages: ``codegen_torch.execute(...,
parallel_partials=)`` (reference tests/test_core_transforms.py and
tests/test_properties.py), ``fusion.fuse_pipeline_stages``
(tests/test_fusion_scheduling.py), ``pipeline.fuse`` /
``pipeline.schedule`` and ``pipeline.external_inputs``; and the
oracle's batched folds (``execute(..., batched_folds=True)``, what
certification runs at full size) against its one-index-at-a-time form.
"""
import numpy as np
import pytest
import torch

from repro.core import codegen_jax as jex
from repro.core import fusion as jfusion
from repro.core import ir as jir
from repro.core import pipeline as jpl
from repro.patterns import analytics as jan

from repro_torch.core import codegen_torch as tex
from repro_torch.core import fusion, ir
from repro_torch.core import pipeline as pl
from repro_torch.patterns import analytics as an


def _sumrows(mod, m, n, zeros):
    x = mod.Tensor("x", (m, n))
    return mod.MultiFold(
        domain=(m, n), range_shape=(m,), init=lambda: zeros((m,)),
        reads=(mod.elem(x),), out_index_map=lambda i, j: (i,),
        update_shape=(1,), fn=lambda s, acc, e: acc + e,
        combine=lambda a, b: a + b, name="sr")


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 6, 12])
@pytest.mark.parametrize("seed", [0, 17])
def test_parallel_partials_match_sequential_and_the_reference(parts, seed):
    import jax.numpy as jnp
    m, n = 12, 8
    xs = np.random.RandomState(seed).randn(m, n).astype(np.float32)
    p = _sumrows(ir, m, n, torch.zeros)
    jp = _sumrows(jir, m, n, jnp.zeros)
    seq = tex.execute(p, {"x": xs}, device="cpu")
    par = tex.execute(p, {"x": xs}, device="cpu", parallel_partials=parts)
    np.testing.assert_allclose(seq.numpy(), par.numpy(), rtol=1e-4)
    jpar = jex.execute(jp, {"x": xs}, parallel_partials=parts)
    np.testing.assert_allclose(par.numpy(), np.asarray(jpar), rtol=1e-5)


def _chain(mod, zeros, reverse: bool, prod_domain: int = 64):
    x = mod.Tensor("x", (64,))
    prod = mod.Map(domain=(prod_domain,), reads=(mod.elem(x),),
                   fn=lambda s, e: e, name="p")
    src = mod.Tensor("p", (64,)) if prod_domain == 64 else x
    amap = (lambda i: (63 - i,)) if reverse else (lambda i: (i,))
    cons = mod.MultiFold(
        domain=(64,), range_shape=(), init=lambda: zeros(()),
        reads=(mod.Access(src, amap, (1,)),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: acc + v, combine=lambda a, b: a + b,
        name="c")
    return prod, cons


def test_fuse_pipeline_stages_rejects_what_the_reference_rejects():
    import jax.numpy as jnp
    for reverse, dom, err, match in (
            (True, 64, NotImplementedError, "row access"),
            (False, 32, ValueError, "share the streaming domain")):
        with pytest.raises(err, match=match):
            jfusion.fuse_pipeline_stages(_chain(jir, jnp.zeros, reverse,
                                                dom), 16)
        with pytest.raises(err, match=match):
            fusion.fuse_pipeline_stages(_chain(ir, torch.zeros, reverse,
                                               dom), 16)


def test_fuse_pipeline_stages_is_the_dag_front_end():
    import jax.numpy as jnp
    stages = _chain(ir, torch.zeros, False)
    fused = fusion.fuse_pipeline_stages(stages, 16)
    jfused = jfusion.fuse_pipeline_stages(_chain(jir, jnp.zeros, False), 16)
    assert ir.describe(fused) == jir.describe(jfused)
    xs = np.arange(64, dtype=np.float32)
    got = tex.execute(fused, {"x": xs}, device="cpu")
    assert float(got) == float(np.asarray(jex.execute(jfused, {"x": xs})))


@pytest.mark.parametrize("name", sorted(an.PIPELINES))
def test_fuse_schedule_and_external_inputs_match_the_reference(name):
    pipe = an.PIPELINES[name](n=512)[0]
    jpipe = jan.PIPELINES[name](n=512)[0]
    assert [(t.name, t.shape, t.dtype) for t in pl.external_inputs(pipe)] \
        == [(t.name, t.shape, t.dtype) for t in jpl.external_inputs(jpipe)]
    if len(pl.output_names(pipe)) == 1:
        assert ir.describe(pl.fuse(pipe, 128)) \
            == jir.describe(jpl.fuse(jpipe, 128))
    else:
        with pytest.raises(ValueError, match="multiple outputs"):
            pl.fuse(pipe, 128)
    for depth in (2, 3):
        mp, jmp = pl.schedule(pipe, 128, depth=depth), \
            jpl.schedule(jpipe, 128, depth=depth)
        assert (mp is None) == (jmp is None)
        if mp is not None:
            assert [(s.name, s.kind, s.words) for s in mp.stages] \
                == [(s.name, s.kind, s.words) for s in jmp.stages]


@pytest.mark.parametrize("name", sorted(an.SUITE))
def test_batched_folds_equal_the_loop(name):
    p, _, mk, _ = an.SUITE[name]()
    inp = mk()
    a = tex.execute(p, inp, device="cpu")
    b = tex.execute(p, inp, device="cpu", batched_folds=True)
    a = a[0] if isinstance(a, tuple) else a
    b = b[0] if isinstance(b, tuple) else b
    # the same function in another summation order (a tree for a root
    # fold over one slot, keyed adds; float64 sums)
    torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", sorted(an.PIPELINES))
def test_batched_unfused_pipelines_equal_the_loop(name):
    pipe, mk, ref = an.PIPELINES[name](n=1024)
    a = pl.run_unfused(pipe, mk(), device="cpu")
    b = pl.run_unfused(pipe, mk(), device="cpu", batched_folds=True)
    if not isinstance(a, dict):
        a, b = {"o": a}, {"o": b}
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=2e-3, atol=2e-3)


def test_batched_fold_tree_keeps_index_order():
    """A combine that keeps the earlier operand on ties (k-means' first
    minimum) picks what the loop picks."""
    x = ir.Tensor("x", (10,))
    p = ir.MultiFold(
        domain=(10,), range_shape=(2,),
        init=lambda: torch.tensor([float("inf"), -1.0]),
        reads=(ir.elem(x),), out_index_map=lambda i: (0,),
        update_shape=(2,),
        fn=lambda s, acc, v: torch.where(
            (v < acc[..., 0])[..., None],
            torch.stack([v, torch.as_tensor(s[0]).to(v.dtype).expand_as(v)],
                        -1), acc),
        combine=lambda a, b: torch.where(a[..., :1] <= b[..., :1], a, b),
        name="amin")
    xs = np.array([3, 1, 4, 1, 5, 9, 2, 6, 1, 3], np.float32)
    a = tex.execute(p, {"x": xs}, device="cpu")
    b = tex.execute(p, {"x": xs}, device="cpu", batched_folds=True)
    assert torch.equal(a, b) and b.tolist() == [1.0, 1.0]
