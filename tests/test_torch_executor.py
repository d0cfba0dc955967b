"""The port's eager oracle (``repro_torch.core.codegen_torch``) against
the JAX package's (``repro.core.codegen_jax``) on the same seeded numpy
inputs: ``gemm`` untiled and tiled, every stage of every pipeline, and
the fused terminal trees; plus the port's vectorised numpy references
against the JAX package's per-row loop references.  float32 rtol/atol
2e-3 (the reference's test tolerance); the integer-valued kmeans
assignment must match exactly.
"""
import numpy as np
import pytest

from repro.core import codegen_jax as jex
from repro.core import pipeline as jpl
from repro.core.strip_mine import tile as jtile
from repro.patterns import analytics as jan

from repro_torch.core import codegen_torch as tex
from repro_torch.core import pipeline as pl
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

NAMES = sorted(an.PIPELINES)
TOL = dict(rtol=2e-3, atol=2e-3)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("tiled", [False, True])
def test_gemm_matches_jax_executor(tiled):
    jp, jsizes, make_inputs, _ = jan.gemm(64, 64, 64, 32, 32, 32)
    tp, tsizes, t_inputs, ref = an.gemm(64, 64, 64, 32, 32, 32)
    inp = make_inputs()
    assert all(np.array_equal(inp[k], v) for k, v in t_inputs().items())
    if tiled:
        jp, tp = jtile(jp, jsizes), tile(tp, tsizes)
    got = tex.execute(tp, inp, device="cpu").numpy()
    _close(got, jex.execute(jp, inp))
    _close(got, ref(inp))


@pytest.mark.parametrize("name", NAMES)
def test_every_stage_matches_jax_executor(name):
    jpipe, j_inputs, _ = jan.PIPELINES[name]()
    tpipe, t_inputs, _ = an.PIPELINES[name]()
    inp = j_inputs()
    assert all(np.array_equal(inp[k], v) for k, v in t_inputs().items())
    _, inter = jpl.run_unfused(jpipe, inp, return_intermediates=True)
    env = dict(inp, **{k: np.asarray(v) for k, v in inter.items()})
    jstages = jpl.stage_map(jpipe)
    for s in pl.topo_stages(tpipe):
        want = np.asarray(jex.execute(jstages[s.name], env))
        got = tex.execute(s, env, device="cpu").numpy()
        if s.name == "km_assign":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_fused_terminal_trees_match_jax_executor(name):
    jpipe, make_inputs, _ = jan.PIPELINES[name]()
    tpipe = an.PIPELINES[name]()[0]
    inp = make_inputs()
    jd, td = jpl.fuse_dag(jpipe, 128), pl.fuse_dag(tpipe, 128)
    for (jn, jt), (tn, tt) in zip(jd.terminals, td.terminals):
        assert jn == tn
        _close(tex.execute(tt, inp, device="cpu").numpy(),
               jex.execute(jt, inp))


@pytest.mark.parametrize("name", NAMES)
def test_vectorised_references_match_loop_references(name):
    _, make_inputs, jref = jan.PIPELINES[name]()
    _, _, tref = an.PIPELINES[name]()
    inp = make_inputs()
    want, got = jref(inp), tref(inp)
    if not isinstance(want, dict):
        want, got = {"out": want}, {"out": got}
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.float32
        _close(got[k], want[k])


def test_flatmap_is_refused_until_its_template_lands():
    """The oracle runs a FlatMap (the reference's ``_execute_flatmap``);
    one nested in a Map is still refused, as in the reference."""
    x = tex.ir.Tensor("x", (8,))
    fm = tex.ir.FlatMap(domain=(8,), reads=(tex.ir.elem(x),),
                        fn=lambda s, e: (e, 1), name="fm")
    xs = np.arange(8, dtype=np.float32)
    buf, count = tex.execute(fm, {"x": xs}, device="cpu")
    np.testing.assert_array_equal(buf.numpy(), xs)
    assert int(count) == 8
    outer = tex.ir.Map(domain=(2,), inner=fm, name="outer")
    with pytest.raises(TypeError, match="FlatMap cannot nest"):
        tex.execute(outer, {"x": xs}, device="cpu")
