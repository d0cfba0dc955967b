"""The port's paged decode on the CPU against the JAX package's:
``codegen_cuda.lower_paged_decode`` (its plain version for CPU tensors)
against ``codegen_pallas.lower_paged_decode`` in interpret mode -- both
layouts, one and two pages per grid step, float32 and bfloat16 pools,
page ids past the pool and below zero, lengths crossing page boundaries:
pools bitwise, output within float32 2e-4; ``models.paged`` (scatter and
gather round trip, paged decode token-identical to the dense oracle for
both ``use_kernel`` values); the kernel's flash-decoding split
(``paged_decode_plain(splits=s)``, ``paged_splits``) against the unsplit
plain version and the reference; ``dse.select_paged_decode_blocks`` plan JSON
exactly as the reference's (``cache=False``) under ``cost.TPU`` at the
TPU's 16 MiB and the H100's 232,448 B, raising where it raises (960 and
1040 tokens on the H100's budget); under the H100's tier a plan at every
context over the kernel's own axes, charged the bytes
``codegen_cuda.pd_smem_bytes`` gives, which equal ``smem_bytes`` read
from ``csrc/paged_decode.cuh``; the traffic model and
``pipeline.ragged_extent``.
"""
import dataclasses
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen_pallas as jcp
from repro.core import cost as jcost
from repro.core import dse as jdse
from repro.core import pipeline as jpl

from repro_torch.configs import get_config
from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, dse
from repro_torch.core import pipeline as pl
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import model, paged

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_cuda import paged_case  # noqa: E402

H100_BUDGET = cost.H100_SXM.onchip_bytes      # 232,448 B
ARCH = "granite-3-2b"
LENS = (3, 5, 9)      # crosses page boundaries at 4 and 8 (ps=4)
PS = 4
GEN = 5


# ------------------------------------------------------------- kernel
# (b, hkv, group, d, ps, npm, pages_per_step)
KERNEL = [(3, 2, 2, 16, 4, 4, 1), (3, 2, 2, 16, 4, 4, 2),
          (5, 2, 4, 32, 8, 6, 3), (2, 1, 3, 64, 16, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("case", KERNEL, ids=str)
def test_lower_paged_decode_matches_pallas(case, layout, dtype):
    b, hkv, group, d, ps, npm, pps = case
    q, k, v, pools, table, lens = paged_case(b, hkv, group, d, ps, npm,
                                             layout, dtype, device="cpu")
    n_phys = pools[0].shape[0]
    for r in range(b):          # dead pages point past the pool or below
        live = int(lens[r]) // ps + 1
        table[r, live:] = torch.tensor([n_phys + 5, -3] * npm)[:npm - live]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jkern = jcp.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                   head_dim=d, page_size=ps, n_pages_max=npm,
                                   layout=layout, pages_per_step=pps)
    want, want_pools = jkern(
        jnp.asarray(q.float().numpy(), jdt), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()),
        tuple(jnp.asarray(p.float().numpy(), jdt) for p in pools),
        jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()))
    kern = cc.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                 head_dim=d, page_size=ps, n_pages_max=npm,
                                 layout=layout, pages_per_step=pps)
    out, new_pools = kern(q, k, v, pools, table, lens)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert all(a is b_ for a, b_ in zip(new_pools, pools))   # in place
    for got, exp in zip(new_pools, want_pools):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(exp, np.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# (b, hkv, group, d, ps, npm): 64-key chunks of 4 and 2 pages, 3 and 4 of
# them in the table; lengths 0, ps - 1, ps, the table's last slot, a chunk's
# last and first keys
SPLIT_CASES = [(6, 2, 3, 16, 16, 12), (6, 1, 4, 32, 32, 8)]
_REFERENCE = {}


def _split_inputs(case, layout):
    b, hkv, group, d, ps, npm = case
    q, k, v, pools, table, lens = paged_case(b, hkv, group, d, ps, npm,
                                             layout, torch.float32,
                                             device="cpu")
    lens[:] = torch.tensor([0, ps - 1, ps, npm * ps - 1, 63, 128])[:b]
    return q, k, v, pools, table, lens


def _split_reference(case, layout):
    """The reference's lower_paged_decode (interpret mode) on the
    inputs of ``_split_inputs``: (output, pools)."""
    if (case, layout) not in _REFERENCE:
        b, hkv, group, d, ps, npm = case
        q, k, v, pools, table, lens = _split_inputs(case, layout)
        jkern = jcp.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                       head_dim=d, page_size=ps,
                                       n_pages_max=npm, layout=layout)
        out, new_pools = jkern(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), tuple(jnp.asarray(p.numpy())
                                          for p in pools),
            jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()))
        _REFERENCE[(case, layout)] = (
            np.asarray(out), [np.asarray(p) for p in new_pools])
    return _REFERENCE[(case, layout)]


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_plain_version_matches_unsplit_and_the_reference(case, layout,
                                                               splits):
    """The kernel's flash-decoding on the CPU: per-part (m, l, acc) over
    each request's own live chunks, merged in split order, equals the
    unsplit plain version and the reference at float32 2e-4, pools
    bitwise; parts past a short request's chunks are empty."""
    want, want_pools = _split_reference(case, layout)
    q, k, v, pools, table, lens = _split_inputs(case, layout)
    unsplit_pools = tuple(p.clone() for p in pools)
    got = cc.paged_decode_plain(q, k, v, pools, table, lens, layout=layout,
                                splits=splits)
    unsplit = cc.paged_decode_plain(q, k, v, unsplit_pools, table, lens,
                                    layout=layout)
    for g, u, w in zip(pools, unsplit_pools, want_pools):
        assert torch.equal(g, u)
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got.numpy(), unsplit.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,splits", [(1, 8), (3, 2), (16, 9), (128, 8)])
def test_split_ranges_cover_the_chunks_in_order(n, splits):
    parts = [cc.pd_split_range(n, s, splits) for s in range(splits)]
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(a[1] == b_[0] for a, b_ in zip(parts, parts[1:]))
    assert parts[-1][1] > parts[-1][0]     # the last part holds the append


# (batch, kv heads, pages in the table, page size) -> splits on 132 SMs:
# granite's serving shape (8 requests, 1,024 tokens, page size 8: 64
# blocks want 4 per SM), the 32-request shapes up to 8,192 tokens (no part
# longer than 16 chunks), a batch that fills the card, one short request
SPLITS = {(8, 8, 128, 8): 9, (32, 8, 1024, 8): 8, (32, 8, 128, 64): 8,
          (64, 8, 128, 8): 1, (64, 8, 1024, 8): 8, (1, 1, 4, 16): 1,
          (2, 2, 4096, 1): 64}


@pytest.mark.parametrize("shape", sorted(SPLITS), ids=str)
def test_paged_splits_rule(shape):
    b, hkv, npm, ps = shape
    splits = cc.paged_splits(b, hkv, npm, ps, 132)
    assert splits == SPLITS[shape]
    if shape == (8, 8, 128, 8):
        assert hkv * b * splits >= 2 * 132


def test_lower_paged_decode_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="must divide"):
        cc.lower_paged_decode(batch=1, kv_heads=1, group=1, head_dim=8,
                              page_size=4, n_pages_max=3, pages_per_step=2)
    with pytest.raises(ValueError, match="layout"):
        cc.lower_paged_decode(batch=1, kv_heads=1, group=1, head_dim=8,
                              page_size=4, n_pages_max=3, layout="ring")
    q, k, v, pools, table, lens = paged_case(2, 2, 2, 16, 4, 3, "split",
                                             torch.float32, device="cpu")
    kern = cc.lower_paged_decode(batch=2, kv_heads=2, group=2, head_dim=16,
                                 page_size=4, n_pages_max=3, layout="fused")
    with pytest.raises(ValueError, match="pools"):
        kern(q, k, v, pools, table, lens)
    kern = cc.lower_paged_decode(batch=2, kv_heads=2, group=2, head_dim=16,
                                 page_size=4, n_pages_max=3)
    with pytest.raises(ValueError, match="shape"):
        kern(q[:1], k, v, pools, table, lens)


# --------------------------------------------------------- paged cache
@pytest.mark.parametrize("layout", dse.PAGED_LAYOUTS)
def test_cache_scatter_gather_roundtrip(layout):
    """``write_tokens`` then ``gather_dense`` is an exact permutation
    round trip for both layouts (the fused packing: K at even heads, V at
    odd)."""
    cfg = get_config(ARCH, smoke=True)
    cache = paged.PagedKVCache.init(cfg, 2, 3 * PS, page_size=PS,
                                    layout=layout, device="cpu")
    rng = np.random.RandomState(0)
    shp = (cfg.n_layers, cfg.n_kv_heads, 7, cfg.head_dim)
    k = torch.as_tensor(rng.randn(*shp).astype(np.float32)).bfloat16()
    v = torch.as_tensor(rng.randn(*shp).astype(np.float32)).bfloat16()
    cache = cache.assign_pages(1, [3, 5, 1], 7)   # a non-linear page map
    cache = cache.write_tokens(1, k, v, 0)
    assert cache.page_table[1].tolist() == [3, 5, 1]
    assert int(cache.seq_lens[1]) == 7
    for li in range(cfg.n_layers):
        ck, cv = cache.gather_dense(li)
        assert torch.equal(ck[1, :, :7], k[li])
        assert torch.equal(cv[1, :, :7], v[li])


def test_cache_init_matches_the_reference_layout():
    cfg = get_config(ARCH, smoke=True)
    split = paged.PagedKVCache.init(cfg, 3, 10, page_size=4, device="cpu")
    fused = paged.PagedKVCache.init(cfg, 3, 10, page_size=4, layout="fused",
                                    n_pages=64, device="cpu")
    assert [tuple(b.shape) for b in split.buffers] == \
        [(cfg.n_layers, 10, 4, cfg.n_kv_heads, cfg.head_dim)] * 2
    assert tuple(fused.buffers[0].shape) == \
        (cfg.n_layers, 64, 4, 2 * cfg.n_kv_heads, cfg.head_dim)
    assert split.page_table.tolist() == [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert (split.n_pages, split.n_pages_max, split.max_context,
            split.batch) == (10, 3, 12, 3)
    with pytest.raises(ValueError, match="layout"):
        paged.PagedKVCache.init(cfg, 1, 8, page_size=4, layout="ring",
                                device="cpu")


def _oracle_tokens(cfg, params, prompt, gen, cmax):
    """Greedy tokens from ``model.decode_step`` with a dense no-wrap
    cache of the page-padded extent, token by token."""
    cache = model.init_cache(cfg, 1, cmax, device="cpu")
    out, nxt = [], None
    ln = prompt.shape[1]
    for i in range(ln + gen):
        tok = prompt[:, i:i + 1] if i < ln else nxt.reshape(1, 1)
        logits, cache = model.decode_step(params, cfg, cache, tok, i)
        nxt = steps.greedy(logits, cfg)
        if i >= ln:
            out.append(int(nxt[0]))
    return out


def _paged_tokens(cfg, params, prompt, gen, cmax, layout, use_kernel):
    cache = paged.PagedKVCache.init(cfg, 1, cmax, page_size=PS,
                                    layout=layout, device="cpu")
    out, nxt = [], None
    ln = prompt.shape[1]
    for i in range(ln + gen):
        tok = prompt[:, i:i + 1] if i < ln else nxt.reshape(1, 1)
        logits, cache = paged.paged_decode_step(params, cfg, cache, tok,
                                                use_kernel=use_kernel)
        nxt = steps.greedy(logits, cfg)
        if i >= ln:
            out.append(int(nxt[0]))
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layout", dse.PAGED_LAYOUTS)
def test_paged_decode_token_identical_to_oracle(layout, use_kernel):
    """The reference path and the kernel's path both match the
    dense-cache oracle token for token: mixed prompt lengths, page
    boundary crossings, both layouts."""
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    cmax = -(-(max(LENS) + GEN) // PS) * PS
    rng = np.random.RandomState(1)
    for ln in LENS:
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab, (1, ln)),
                                 dtype=torch.int32)
        want = _oracle_tokens(cfg, params, prompt, GEN, cmax)
        got = _paged_tokens(cfg, params, prompt, GEN, cmax, layout,
                            use_kernel)
        assert got == want, f"diverged at ln={ln}"


def test_paged_decode_step_advances_every_length():
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    cache = paged.PagedKVCache.init(cfg, 2, 8, page_size=4, device="cpu")
    logits, nxt = paged.paged_decode_step(
        params, cfg, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert nxt.seq_lens.tolist() == [1, 1] and cache.seq_lens.tolist() \
        == [0, 0]
    assert nxt.buffers[0] is cache.buffers[0]          # pools in place


def test_paged_rejects_sliding_window_and_other_families():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="sliding"):
        paged.PagedKVCache.init(dataclasses.replace(cfg, sliding_window=4),
                                1, 8, page_size=4, device="cpu")
    ssm = get_config("mamba2-370m", smoke=True)
    with pytest.raises(NotImplementedError, match="dense/moe"):
        paged.paged_decode_step({}, ssm, None,
                                torch.zeros((1, 1), dtype=torch.int32))


# ------------------------------------------------------------ the plan
# (max_len, budget): the reference's plan, or its raise at the H100's
# budget (960 and 1040 tokens: no tile candidate fits)
PLANS = [(48, None), (48, H100_BUDGET), (256, None), (256, H100_BUDGET),
         (768, H100_BUDGET), (960, None), (960, H100_BUDGET),
         (1024, H100_BUDGET), (1040, H100_BUDGET)]


def _fields(plan):
    d = plan.to_json()
    d.pop("key")
    return d


@pytest.mark.parametrize("max_len,budget", PLANS, ids=str)
def test_select_paged_decode_blocks_matches_the_reference(max_len, budget):
    try:
        jblocks, jplan = jdse.select_paged_decode_blocks(
            max_len, 64, vmem_budget=budget, cache=False)
    except ValueError as e:
        assert "no tile candidate fits" in str(e)
        with pytest.raises(ValueError, match="no tile candidate fits"):
            dse.select_paged_decode_blocks(max_len, 64, tier=cost.TPU,
                                           vmem_budget=budget)
        assert budget == H100_BUDGET and max_len in (960, 1040)
        return
    blocks, plan = dse.select_paged_decode_blocks(max_len, 64, tier=cost.TPU,
                                                  vmem_budget=budget)
    assert blocks == jblocks
    assert _fields(plan) == _fields(jplan)


def test_paged_plan_for_the_card_off_the_card():
    """Without a tier the plan is the H100's, over the kernel's own axes:
    a layout and a page size, the block at the kernel's chunk of PD_KC
    keys and the depth at its PD_STAGES ring slots, as chip_smoke.py's
    serving phase plans it; at 960 tokens, where the reference's search
    has no plan at this budget, the card's selector plans too."""
    ops.clear_plan_memo()
    blocks, plan = ops.resolve_plan("paged_decode", 1024, 64, device="cpu")
    assert blocks == ("split", 8, cc.PD_KC, cc.PD_STAGES)
    assert plan.sizes["pd_page"] == (8,)
    assert plan.sizes["pd_kv"] == (cc.PD_KC,)
    assert plan.depths["pd_kv"] == cc.PD_STAGES
    blocks, plan = ops.resolve_plan("paged_decode", 960, 64, device="cpu")
    assert blocks[2:] == (cc.PD_KC, cc.PD_STAGES)
    assert plan.vmem_bytes <= H100_BUDGET


# the contexts the card's selector must plan at every head dim, the
# reference's raises at its budget among them
CARD_CONTEXTS = (256, 512, 544, 576, 640, 768, 896, 960, 1024, 1040, 1056,
                 1088, 1152, 1280, 1536, 2048, 4096, 8192)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("max_len", CARD_CONTEXTS)
def test_paged_plan_on_the_card_charges_the_kernels_bytes(max_len, d):
    """Under the H100's tier every context plans, at the kernel's block
    and depth, charged the shared bytes the kernel allocates: the
    largest group and float32 pools unless told, else the group rounded
    as the launch rounds it and the pools' type."""
    blocks, plan = dse.select_paged_decode_blocks(max_len, d,
                                                  tier=cost.H100_SXM)
    layout, ps, blk, depth = blocks
    assert layout in dse.PAGED_LAYOUTS and ps <= cc.PD_KC
    assert (blk, depth) == (cc.PD_KC, cc.PD_STAGES)
    assert plan.vmem_bytes == cc.pd_smem_bytes(
        cc.PD_STAGES, cc.PD_KC, cc.PD_GMAX, d, torch.float32)
    for group, dtype in ((5, "bfloat16"), (4, "float32"), (12, "bfloat16")):
        _, plan = dse.select_paged_decode_blocks(
            max_len, d, group, dtype, tier=cost.H100_SXM)
        assert plan.vmem_bytes == cc.pd_smem_bytes(
            cc.PD_STAGES, cc.PD_KC, cc.pd_launch_group(group), d, dtype)
        assert plan.vmem_bytes <= H100_BUDGET


def _cuh_constants():
    """``pdec``'s constants, its ``smem_bytes`` formula and the groups its
    ``launch`` instantiates, read from ``csrc/paged_decode.cuh``."""
    text = (Path(cc.__file__).resolve().parent.parent / "kernels" / "csrc"
            / "paged_decode.cuh").read_text()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (\w+) = (\d+);", text)}
    body = re.search(r"smem_bytes\(int d\) \{\s*return ([^;]+);",
                     text).group(1)
    launch = re.search(
        r"const auto run = group <= (\d+) \? &launch_g<T, Q, (\d+)>\s*"
        r": group <= (\d+) \? &launch_g<T, Q, (\d+)>\s*"
        r": &launch_g<T, Q, (\w+)>;", text).groups()
    return consts, body, launch


def test_paged_kernel_bytes_match_the_cuh():
    """``pd_smem_bytes`` and the Python constants are the kernel's:
    ``smem_bytes<T, G>(d)`` evaluated from its source text at every group
    rounding, head dim and pool type; ``pd_launch_group`` picks the
    instantiation ``launch`` picks."""
    consts, body, launch = _cuh_constants()
    assert (consts["KC"], consts["STAGES"], consts["GMAX"],
            consts["DMAX"]) == (cc.PD_KC, cc.PD_STAGES, cc.PD_GMAX,
                                cc.PD_DMAX)
    lim4, g4, lim8, g8, gmax = launch
    assert (int(lim4), int(g4), int(lim8), int(g8), gmax) == \
        (4, 4, 8, 8, "GMAX")
    for group in range(1, cc.PD_GMAX + 1):
        want = 4 if group <= 4 else 8 if group <= 8 else consts["GMAX"]
        assert cc.pd_launch_group(group) == want
    for g in (4, 8, 16):
        for d in (8, 64, 80, 128):
            for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
                expr = body.replace("(int)sizeof(T)", str(size))
                want = eval(expr, {}, {"STAGES": consts["STAGES"],
                                       "KC": consts["KC"], "G": g, "d": d})
                assert cc.pd_smem_bytes(cc.PD_STAGES, cc.PD_KC, g, d,
                                        dtype) == want
    assert cc.pd_smem_bytes(2, 64, 8, 128, "bfloat16") == 67_680
    with pytest.raises(ValueError):
        cc.pd_launch_group(cc.PD_GMAX + 1)


def test_paged_plan_on_the_card_is_priced_not_timed():
    """``measure="top_k"`` on the card's tier keeps the priced plan (the
    proxy DAG is not the kernel) and records a ``lower-unsupported``
    fallback, as for a program no template takes."""
    from repro_torch.core import resilience

    n = len(resilience.LOG.events(stage="explore"))
    blocks, plan = dse.select_paged_decode_blocks(1024, 64,
                                                  tier=cost.H100_SXM,
                                                  measure="top_k")
    assert blocks == dse.select_paged_decode_blocks(
        1024, 64, tier=cost.H100_SXM)[0] and not plan.measured
    events = resilience.LOG.events(stage="explore")[n:]
    assert [(e.kind, e.action) for e in events] == \
        [("lower-unsupported", "fallback")]


def test_paged_plan_on_the_card_raises_past_the_kernel():
    """A head dim past DMAX, or one whose rows are not whole 16-byte
    pieces, has no plan on the card; under ``cost.TPU`` the reference's
    search still raises where it raises."""
    for d, dtype in ((cc.PD_DMAX * 2, "float32"), (36, "bfloat16")):
        with pytest.raises(ValueError, match="no tile candidate fits"):
            dse.select_paged_decode_blocks(1024, d, 4, dtype,
                                           tier=cost.H100_SXM)
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.select_paged_decode_blocks(960, 64, tier=cost.TPU,
                                       vmem_budget=H100_BUDGET)


def test_paged_decode_pipeline_bodies_match_jax():
    """The proxy DAG's torch bodies compute what the reference's JAX
    bodies compute (append merges the token at seq_len; the fold sums
    exp(q.k * scale) v over live rows)."""
    for layout in dse.PAGED_LAYOUTS:
        jp = jdse.paged_decode_pipeline(12, 4, 8, layout)
        tp = dse.paged_decode_pipeline(12, 4, 8, layout)
        assert [s.name for s in tp.stages] == [s.name for s in jp.stages]
        rng = np.random.RandomState(3)
        fold, jfold = tp.stages[-1], jp.stages[-1]
        width = 16 if layout == "fused" else 8
        row, qv, ln = rng.randn(1, width), rng.randn(1, 8), np.array([5])
        rows = (row,) if layout == "fused" else (row[:, :8], rng.randn(1, 8))
        for s in (3, 7):
            acc = np.zeros(8, np.float32)
            want = jfold.fn(jnp.asarray([s]), jnp.asarray(acc),
                            *(jnp.asarray(r, jnp.float32) for r in rows),
                            jnp.asarray(qv, jnp.float32),
                            jnp.asarray(ln, jnp.int32))
            got = fold.fn(torch.tensor([s]), torch.as_tensor(acc),
                          *(torch.as_tensor(r, dtype=torch.float32)
                            for r in rows),
                          torch.as_tensor(qv, dtype=torch.float32),
                          torch.as_tensor(ln, dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        app, japp = tp.stages[0], jp.stages[0]
        page, new = rng.randn(1, width), rng.randn(1, width)
        for s in (4, 5):
            want = japp.fn(jnp.asarray([s]), jnp.asarray(page, jnp.float32),
                           jnp.asarray(new, jnp.float32), jnp.asarray(ln))
            got = app.fn(torch.tensor([s]),
                         torch.as_tensor(page, dtype=torch.float32),
                         torch.as_tensor(new, dtype=torch.float32),
                         torch.as_tensor(ln))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ traffic, ragged extent
@pytest.mark.parametrize("lens,ps", [([5, 9, 33], 8), ([1], 64),
                                     ([0, 7, 8, 16], 4)])
def test_decode_traffic_words_match_the_reference(lens, ps):
    assert cost.paged_decode_traffic_words(lens, ps, 2, 16) == \
        jcost.paged_decode_traffic_words(lens, ps, 2, 16)
    b, c = len(lens), max(lens) + 1
    assert cost.dense_decode_traffic_words(b, c, 2, 16) == \
        jcost.dense_decode_traffic_words(b, c, 2, 16)


def test_decode_traffic_model_prefers_live_pages():
    dense = cost.dense_decode_traffic_words(3, 64, 2, 16)
    pg = cost.paged_decode_traffic_words([5, 9, 33], 8, 2, 16)
    assert pg < dense
    assert cost.paged_decode_traffic_words([9], 8, 2, 16) == \
        2 * 2 * 8 * 2 * 16 + 3 * 2 * 16


@pytest.mark.parametrize("layout", ["split", "fused"])
def test_ragged_extent_matches_the_reference(layout):
    rag = pl.ragged_extent(dse.paged_decode_pipeline(12, 4, 8, layout))
    jrag = jpl.ragged_extent(jdse.paged_decode_pipeline(12, 4, 8, layout))
    assert (rag.max, rag.length_name, rag.granularity, rag.max_units) == \
        (jrag.max, jrag.length_name, jrag.granularity, jrag.max_units) \
        == (12, "seq_len", 4, 3)
    assert pl.ragged_extent(dse.filter_fold_pipeline(64)) is None


def test_paged_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        paged.PagedKVCache.init(cfg, 1, 8, page_size=4)
