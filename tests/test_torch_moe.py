"""The port's MoE family (``repro_torch.models.moe`` and the MoE branches
of ``transformer``, ``paged`` and ``launch.serve``) on the CPU against
the JAX package's, on the same seeded numpy inputs and the reference's
own weights carried across by ``convert.params_from_numpy``.

``moe_ffn`` of Mixtral and Llama-4 Maverick SMOKE: the routing (each
token's top-k experts and each choice's dispatch slot, the dump row for
a choice past its expert's capacity) equal to the reference's exactly,
with one and with several routing groups and with capacity drops, and
the output at float32 2e-3 / bfloat16 2e-2 x the largest magnitude;
``top_k`` orders ties as ``jax.lax.top_k``; ``router_counts`` through
the ``groupby_fold`` kernel's plain version and through the ``ref``
oracle exactly equal to the reference's, with and without its Pallas
kernel (interpret mode).  Logits of ``forward`` and ``decode_step`` at
the tolerances of ``test_torch_models.py``; ``paged_decode_step`` and
``serve_continuous`` of Llama-4 SMOKE token-identical to the reference's
in float32 and bfloat16.  Mixtral's sliding window refuses the paged
cache in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import paged as jpaged

from repro_torch.configs import get_config
from repro_torch.core import codegen_cuda as cc
from repro_torch.kernels import groupby_fold as gbf
from repro_torch.launch import serve, steps
from repro_torch.models import convert, model, moe, paged

MOE = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
LLAMA4 = "llama4-maverick-400b-a17b"
TOL = {"bfloat16": 2e-2, "float32": 2e-3}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, dtype):
    """rtol TOL; atol TOL in float32, TOL x max|want| in bfloat16."""
    want = _np(want)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == "bfloat16" else 1)
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype], atol=atol)


def _params(arch, dtype, seed=0, **cut):
    """The reference's params for ``arch`` SMOKE (with ``cut``'s fields
    replaced) in ``dtype``, the zero-initialised ones replaced by seeded
    noise, as the reference's arrays and as the port's tensors."""
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype, **cut)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype, **cut)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    for name, (shape, kind) in sorted(jmodel.param_shapes(jcfg).items()):
        if kind == "zeros":
            jp[name] = jnp.asarray(rng.randn(*shape) * 0.1, dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    return jcfg, cfg, jp, tp


def _layer(params, prefix="moe_"):
    """One MoE layer's slices (the first), keyed as ``moe_ffn`` takes
    them."""
    return {k[len(prefix):]: v[0] for k, v in params.items()
            if k.startswith(prefix)}


def _x(cfg, b, s, seed):
    """Hidden states at the scale an RMS-normed residual has."""
    return np.random.RandomState(seed).randn(b, s, cfg.d_model) \
        .astype(np.float32)


def _jax_routing(p, x, cfg, gsz):
    """The reference's routing of ``moe_ffn`` (repro/models/moe.py,
    gate logits through ``dest``), step for step in JAX: the top-k
    experts and each choice's dispatch slot."""
    b, s, d = x.shape
    g = b * s // gsz
    cap = jmoe.capacity(cfg, gsz)
    xt = x.reshape(g, gsz, d)
    logits = jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    _, topi = jax.lax.top_k(logits, cfg.top_k)
    n = gsz * cfg.top_k
    flat_e = topi.reshape(g, n)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    is_new = jnp.concatenate(
        [jnp.ones((g, 1), bool), sorted_e[:, 1:] != sorted_e[:, :-1]],
        axis=1)
    seg_start = jax.lax.cummax(jnp.where(is_new, idx, 0), axis=1)
    inv = jnp.argsort(order, axis=1)
    slot = jnp.take_along_axis(idx - seg_start, inv,
                               axis=1).reshape(g, gsz, cfg.top_k)
    dest = jnp.where(slot < cap, topi * cap + slot, cfg.n_experts * cap)
    return np.asarray(topi), np.asarray(dest)


# ------------------------------------------------------------ routing
def test_top_k_orders_ties_as_jax():
    """Equal values: the lower index first, as ``jax.lax.top_k``."""
    v = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                  [0.0, -1.0, 0.0, 5.0, -1.0, 5.0]], np.float32)
    for k in (1, 2, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = moe.top_k(torch.as_tensor(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_capacity_matches_jax():
    for arch in MOE:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for t in (1, 8, 100, 960, 4096):
            for cf in (0.25, 1.25, 2.0):
                assert moe.capacity(cfg.with_(capacity_factor=cf), t) == \
                    jmoe.capacity(jcfg.with_(capacity_factor=cf), t)


# (arch, dtype, capacity factor, group size): 1.25 is the configs',
# 0.25 drops choices past each expert's capacity; a group size of 16
# cuts the 2 x 24 tokens into 3 routing groups
CASES = [(a, dt, cf, gs) for a in MOE for dt in ("float32", "bfloat16")
         for cf, gs in ((1.25, None), (0.25, None), (0.25, 16))]


@pytest.mark.parametrize("arch,dtype,cf,gsz", CASES, ids=str)
def test_moe_ffn_matches_jax(arch, dtype, cf, gsz, monkeypatch):
    if gsz is not None:
        monkeypatch.setattr(moe, "GROUP_SIZE", gsz)
        monkeypatch.setattr(jmoe, "GROUP_SIZE", gsz)
    jcfg, cfg, jp, tp = _params(arch, dtype, capacity_factor=cf)
    x = _x(cfg, 2, 24, 7)
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jl, tl = _layer(jp), _layer(tp)
    g = min(moe.GROUP_SIZE, 48)
    cap = moe.capacity(cfg, g)
    want_i, want_dest = _jax_routing(jl, jx, jcfg, g)
    gate = torch.einsum("gtd,de->gte", tx.reshape(-1, g, cfg.d_model).float(),
                        tl["router"].float())
    topi, gates, dest = moe.route(gate, cfg, cap)
    np.testing.assert_array_equal(topi.numpy(), want_i)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    if cf < 1 and gsz is None:          # the dump row takes choices
        assert int((dest == cfg.n_experts * cap).sum()) > 0
    want = jmoe.moe_ffn(jl, jx, jcfg)
    got = moe.moe_ffn(tl, tx, cfg)
    assert got.shape == want.shape and str(got.dtype) == f"torch.{dtype}"
    _close(got, want, dtype)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", MOE)
def test_router_counts_match_jax(arch, use_kernel):
    """The plain version of the ``groupby_fold`` kernel (``use_kernel``)
    and the ``ref`` oracle both equal the reference's counts with and
    without its Pallas kernel, exactly; 256 tokens, the kernel's block."""
    jcfg, cfg, jp, tp = _params(arch, "float32")
    x = _x(cfg, 4, 64, 8)
    jl, tl = _layer(jp), _layer(tp)
    before = gbf.groupby_fold.launches
    got = moe.router_counts(tl, torch.as_tensor(x), cfg,
                            use_kernel=use_kernel)
    assert gbf.groupby_fold.launches == before          # the plain version
    for use_pallas in (False, True):
        want = jmoe.router_counts(jl, jnp.asarray(x), jcfg,
                                  use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) == 256 and got.shape == (cfg.n_experts,)


# -------------------------------------------------------------- models
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_match_jax(arch, dtype):
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 12)) \
        .astype(np.int32)
    want = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = model.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape and str(got.dtype) == f"torch.{dtype}"
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_step_logits_and_cache_match_jax(arch, dtype):
    """A 5-token prefill block, then 4 single-token steps (Mixtral's
    window of 32 holds them all)."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jc = jmodel.init_cache(jcfg, 2, 12)
    tc = model.init_cache(cfg, 2, 12, device="cpu")
    for i0, i1 in [(0, 5)] + [(i, i + 1) for i in range(5, 9)]:
        want, jc = jmodel.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, i0:i1]),
                                      jnp.int32(i0))
        got, tc = model.decode_step(tp, cfg, tc,
                                    torch.as_tensor(toks[:, i0:i1]), i0)
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype)


def test_interleaved_layers_take_their_own_stacks():
    """Llama-4 at 4 layers: dense layers 0 and 2 read the dense stacks'
    rows 0 and 1, MoE layers 1 and 3 the MoE stacks' rows 0 and 1, every
    layer its own attention row (the reference's super-block order)."""
    from repro_torch.models import transformer

    cfg = get_config(LLAMA4, smoke=True).with_(n_layers=4)
    params = model.init_params(cfg, 0, "cpu")
    got = [(layer, is_moe, sl["wq"].data_ptr(),
            (sl["moe_we1"] if is_moe else sl["w1"]).data_ptr())
           for layer, (sl, is_moe)
           in enumerate(transformer.super_blocks(params, cfg))]
    wq, w1, we1 = params["wq"], params["w1"], params["moe_we1"]
    assert got == [(0, False, wq[0].data_ptr(), w1[0].data_ptr()),
                   (1, True, wq[1].data_ptr(), we1[0].data_ptr()),
                   (2, False, wq[2].data_ptr(), w1[1].data_ptr()),
                   (3, True, wq[3].data_ptr(), we1[1].data_ptr())]


# ------------------------------------------------------ paged decode
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["split", "fused"])
def test_paged_decode_step_matches_jax(layout, dtype):
    """Llama-4 SMOKE: 3 requests prefilled into the pool, then 4 joint
    paged steps through the kernel's plain version, fed the reference's
    greedy tokens: the port's tokens equal the reference's at every
    step, and its logits lie within the tolerance."""
    jcfg, cfg, jp, tp = _params(LLAMA4, dtype)
    lens, ps, npm = [3, 6, 9], 4, 4
    toks = np.random.RandomState(9).randint(0, cfg.vocab, (3, 9))
    jc = jpaged.PagedKVCache.init(jcfg, 3, npm * ps, page_size=ps,
                                  layout=layout)
    tc = paged.PagedKVCache.init(cfg, 3, npm * ps, page_size=ps,
                                 layout=layout, device="cpu")
    for r, ln in enumerate(lens):
        prompt = jnp.asarray(toks[r:r + 1, :ln])
        _, dc = jmodel.decode_step(jp, jcfg, jmodel.init_cache(jcfg, 1, ln),
                                   prompt, jnp.int32(0))
        pages = list(range(1 + r * npm, 1 + (r + 1) * npm))
        jc = jc.assign_pages(r, pages, ln)
        jc = jc.write_tokens(r, dc["k"][:, 0], dc["v"][:, 0], 0)
        tc = tc.assign_pages(r, pages, ln)
        k, v = (torch.as_tensor(np.array(dc[n][:, 0].astype(jnp.float32)))
                .to(getattr(torch, dtype)) for n in ("k", "v"))
        tc = tc.write_tokens(r, k, v, 0)
    tok = toks[:, -1:].astype(np.int32)
    for _ in range(4):
        want, jc = jpaged.paged_decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                            use_pallas=True)
        got, tc = paged.paged_decode_step(tp, cfg, tc, torch.as_tensor(tok),
                                          use_kernel=True)
        _close(got, want, dtype)
        wtok = np.asarray(jnp.argmax(jmodel.mask_vocab_pad(want, jcfg)
                                     [:, -1], -1))
        np.testing.assert_array_equal(steps.greedy(got, cfg).numpy(), wtok)
        tok = wtok[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))


def test_mixtral_refuses_the_paged_cache_in_both_packages():
    jcfg, cfg = jget_config(MOE[0], smoke=True), get_config(MOE[0],
                                                            smoke=True)
    with pytest.raises(NotImplementedError, match="sliding"):
        jpaged.PagedKVCache.init(jcfg, 1, 8, page_size=4)
    with pytest.raises(NotImplementedError, match="sliding"):
        paged.PagedKVCache.init(cfg, 1, 8, page_size=4, device="cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_continuous_matches_jax(dtype, monkeypatch):
    """Llama-4 SMOKE over the paged pool (admit/evict churn, more
    requests than slots, the kernel's plain version, certification on):
    every request's tokens identical to the reference's
    ``serve_continuous`` on the same weights, and its trace counts."""
    lens, gen, slots = (3, 5, 9, 4), 3, 2
    jcfg = jget_config(LLAMA4, smoke=True).with_(dtype=dtype)
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(LLAMA4, smoke=True).with_(dtype=dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    before = cc.lower_paged_decode.launches
    toks, stats = serve.serve_continuous(LLAMA4, True, slots, gen,
                                         prompt_lens=lens, params=tp,
                                         device="cpu", dtype=dtype)
    assert cc.lower_paged_decode.launches == before   # the plain version
    assert stats["certified"] is True and stats["use_pallas"]
    assert stats["admitted"] == stats["evicted"] == len(lens)
    want, jstats = jserve.serve_continuous(
        LLAMA4, True, slots, gen, prompt_lens=lens,
        page_size=stats["page_size"], layout=stats["layout"])
    keys = ("steps", "admitted", "evicted", "occupancy",
            "modeled_paged_traffic_words", "modeled_dense_traffic_words")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    if dtype == "float32":
        np.testing.assert_array_equal(toks, want)
        return
    # bfloat16: identical up to a request's first step where the
    # reference's own logits tie at the top within the bf16 tolerance
    # (ROADMAP §3: two summation orders break such ties either way); past
    # it the request's context differs, so its tokens are not compared
    pool = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (len(lens), max(lens)))
    ties = 0
    for r, ln in enumerate(lens):
        diff = np.flatnonzero(toks[r] != want[r])
        if not diff.size:
            continue
        t = int(diff[0])
        row = _reference_row(jp, jcfg, pool[r, :ln], want[r, :t])
        assert serve.near_best(row, int(toks[r, t]), dtype), (r, t)
        ties += 1
    assert ties <= 1, ties


def _reference_row(jp, jcfg, prompt, served):
    """The reference's greedy logits (pad vocab masked, float32) for the
    served token after ``served``: its dense ``decode_step`` over the
    prompt (one block), the prompt's greedy token, then ``served``."""
    cache = jmodel.init_cache(jcfg, 1, len(prompt) + 1 + len(served))
    logits, cache = jmodel.decode_step(
        jp, jcfg, cache, jnp.asarray(prompt[None], jnp.int32), jnp.int32(0))
    seq = [int(jnp.argmax(jmodel.mask_vocab_pad(logits, jcfg)[0, -1]))]
    seq += [int(x) for x in served]
    logits, _ = jmodel.decode_step(jp, jcfg, cache,
                                   jnp.asarray([seq], jnp.int32),
                                   jnp.int32(len(prompt)))
    return torch.as_tensor(np.array(jmodel.mask_vocab_pad(
        logits, jcfg)[0, -1].astype(jnp.float32)))


def test_serve_and_private_serve_continuous_agree():
    """``serve`` runs the MoE family, and ``_serve_continuous`` on the
    config ``serve_continuous`` builds returns the same tokens."""
    cfg = get_config(LLAMA4, smoke=True)
    out = serve.serve(LLAMA4, True, 2, 4, 2, device="cpu")
    assert out.shape == (2, 2)
    a, sa = serve.serve_continuous(LLAMA4, True, 2, 3, prompt_lens=(4, 6),
                                   device="cpu")
    b, sb = serve._serve_continuous(cfg, 2, 3, prompt_lens=(4, 6),
                                    device="cpu")
    np.testing.assert_array_equal(a, b)
    assert sa["page_size"] == sb["page_size"] and sa["steps"] == sb["steps"]


def _reference_serve_row(jp, jcfg, prompt, served, gen):
    """The reference's greedy logits (pad vocab masked, float32) for the
    served token after ``served`` on ``serve``'s own path: the prompt
    prefilled through ``_prefill`` (chunked at the KV ring, so a sliding
    window's prompt longer than its ring prefills as the server
    prefills it), then one decode step per token fed: the prompt's
    greedy token, then ``served``."""
    from repro.launch import steps as jsteps

    ln = len(prompt)
    cache = jmodel.init_cache(jcfg, 1, ln + gen)
    nxt, cache = jserve._prefill(
        jax.jit(jsteps.make_cache_prefill_step(jcfg)), jp, cache,
        jnp.asarray(prompt[None], jnp.int32), jserve._ring_len(jcfg, ln + gen))
    step = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, jcfg, c, t, i))
    logits = None
    for i, tok in enumerate([int(nxt[0])] + [int(x) for x in served]):
        logits, cache = step(jp, cache, jnp.asarray([[tok]], jnp.int32),
                             jnp.int32(ln + i))
    return torch.as_tensor(np.array(jmodel.mask_vocab_pad(
        logits, jcfg)[0, -1].astype(jnp.float32)))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lens", [(6, 4, 6), (40, 20, 40)], ids=str)
def test_dense_cache_serve_matches_jax(arch, dtype, lens, monkeypatch):
    """``serve`` (the dense cache, block prefill chunked at the ring:
    40-token prompts pass Mixtral's 32-token window) returns the
    reference's tokens on the same weights, in input order: float32
    identical; bfloat16 identical up to a request's first step where the
    reference's own logits tie at the top within the bfloat16 tolerance
    (past it the request's context differs)."""
    gen = 4
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    want = jserve.serve(arch, True, 3, 6, gen, prompt_lens=lens)
    got = serve.serve(arch, True, 3, 6, gen, prompt_lens=lens, params=tp,
                      device="cpu")
    assert got.shape == want.shape == (3, gen)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    pool = np.random.RandomState(0).randint(0, cfg.vocab, (3, max(lens)))
    ties = 0
    for r, ln in enumerate(lens):
        diff = np.flatnonzero(got[r] != want[r])
        if not diff.size:
            continue
        t = int(diff[0])
        row = _reference_serve_row(jp, jcfg, pool[r, :ln], want[r, :t], gen)
        assert serve.near_best(row, int(got[r, t]), dtype), (r, t)
        ties += 1
    assert ties <= 1, ties
