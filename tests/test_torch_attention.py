"""The port's attention kernel layer on the CPU against the JAX package's:
``repro_torch.kernels.flash_attention`` (its plain version, ``device="cpu"``)
against the Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py`` (float32 2e-4, the reference tests' tolerance),
in bfloat16 (2e-2), at a decode row, at head dim 80 and with ``sq > sk``,
whose rows that see no key are the mean of V in both; the plain version
with the kernels' chunk skipping and key splits (``skip_masked``,
``splits``) against the same Pallas kernel, with the rule's exception
for tiles holding a keyless row shown to matter, and the kernels'
dispatch and launch plans; ``ref.attention``
and ``ops.attention`` against the JAX ones; ``select_attention_blocks``
exactly as the reference's (``cache=False``) under ``cost.TPU``, at the
TPU's 16 MiB and the H100's 232,448 B, raising where it raises; and the
model configurations (``repro_torch.configs``) field by field, with their
parameter and FLOP counts.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import codegen_jax as jex
from repro.core import dse as jdse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash

from repro_torch import configs
from repro_torch.core import codegen_torch as tex
from repro_torch.core import cost, dse
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

H100_BUDGET = cost.H100_SXM.onchip_bytes      # 232,448 B


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(b, hq, hkv, sq, sk, d, seed=0):
    return (_r(seed, b, hq, sq, d), _r(seed + 1, b, hkv, sk, d),
            _r(seed + 2, b, hkv, sk, d))


# ----------------------------------------------------- flash attention
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,bq,bk", [
    (1, 4, 4, 128, 128, 64, 64, 64),    # MHA
    (2, 8, 2, 128, 128, 32, 128, 64),   # GQA 4:1
    (1, 4, 1, 64, 64, 32, 32, 32),      # MQA
    (1, 2, 2, 64, 256, 32, 64, 64),     # decode-ish: kv longer than q
    (2, 8, 2, 1, 256, 64, 1, 64),       # a decode row
    (1, 4, 2, 64, 64, 80, 32, 32),      # head dim 80 (zamba2)
])
def test_flash_attention_causal_matches_jax(b, hq, hkv, sq, sk, d, bq, bk):
    q, k, v = _qkv(b, hq, hkv, sq, sk, d)
    want = jflash(q, k, v, causal=True, block_q=bq, block_k=bk)
    got = flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk,
                          device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_attention_sliding_window_matches_jax():
    q, k, v = _qkv(1, 4, 2, 256, 256, 32)
    want = jflash(q, k, v, causal=True, window=64, block_q=64, block_k=64)
    got = flash_attention(q, k, v, causal=True, window=64, block_q=64,
                          block_k=64, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_attention_noncausal_matches_jax():
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=3)
    want = jflash(q, k, v, causal=False, block_q=32, block_k=32)
    got = flash_attention(q, k, v, causal=False, block_q=32, block_k=32,
                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_bfloat16_matches_jax(window):
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=5)
    want = jflash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                  causal=True, window=window, block_q=64, block_k=32)
    got = flash_attention(*(torch.as_tensor(t).bfloat16() for t in (q, k, v)),
                          causal=True, window=window, block_q=64, block_k=32,
                          device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("types", [("float16",) * 3,
                                   ("bfloat16", "float32", "float32"),
                                   ("float32", "bfloat16", "bfloat16")])
def test_flash_attention_takes_the_reference_kernels_input_types(types):
    """The reference's kernel takes any floating types (float32 scores, p
    rounded to V's type) and returns q's type; the port computes a mix
    in float32 and returns q's type."""
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=7)
    want = jflash(*(jnp.asarray(t, dt) for t, dt in zip((q, k, v), types)),
                  causal=True, block_q=64, block_k=32)
    got = flash_attention(*(torch.as_tensor(t).to(getattr(torch, dt))
                            for t, dt in zip((q, k, v), types)),
                          causal=True, block_q=64, block_k=32, device="cpu")
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{types[0]}"
    tol = 2e-2 if "bfloat16" in types else 2e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_rows_without_a_visible_key_are_the_mean_of_v():
    """Causal with sq > sk: rows 0..sq-sk-1 see no key.  The Pallas
    kernel's finite -1e30 mask makes them the mean of V (the oracle gives
    NaN); the port reproduces the kernel."""
    q, k, v = _r(0, 1, 2, 8, 16), _r(1, 1, 1, 4, 16), _r(2, 1, 1, 4, 16)
    want = np.asarray(jflash(q, k, v, causal=True, block_q=4, block_k=4))
    got = flash_attention(q, k, v, causal=True, block_q=4, block_k=4,
                          device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0, :, :4],
                               np.broadcast_to(v[0, 0].mean(0), (2, 4, 16)),
                               rtol=1e-5, atol=1e-5)
    oracle = ref.attention(*map(torch.as_tensor, (q, k, v))).numpy()
    assert np.isnan(oracle[0, :, :4]).all()
    np.testing.assert_allclose(got[0, :, 4:], oracle[0, :, 4:], rtol=2e-4,
                               atol=2e-4)


def test_plain_version_does_not_depend_on_the_kv_block():
    q, k, v = _qkv(1, 4, 2, 64, 128, 32, seed=7)
    a = flash_attention_plain(*map(torch.as_tensor, (q, k, v)), window=40,
                              block_k=16)
    b = flash_attention_plain(*map(torch.as_tensor, (q, k, v)), window=40,
                              block_k=128)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_attention_auto_tile_matches_jax():
    """The reference plans for its TPU budget, the port (CPU tensors) for
    the card's: the values agree."""
    q, k, v = _qkv(1, 4, 2, 256, 256, 64)
    want = jflash(q, k, v, causal=True, auto_tile=True)
    got = flash_attention(q, k, v, causal=True, auto_tile=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["blocks", "dtype", "heads"])
def test_flash_attention_refuses_what_it_cannot_take(bad):
    q, k, v = (torch.as_tensor(t) for t in _qkv(1, 4, 2, 64, 64, 16))
    kw = {"device": "cpu"}
    if bad == "blocks":
        kw["block_q"] = 48
    elif bad == "dtype":        # any floating types are taken; not ints
        k = k.int()
    else:
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


# ------------------------------------- the kernels' chunk skipping and splits
# (b, hq, hkv, sq, sk, d, causal, window, block_q, block_k): causal prefill,
# a window, decode rows at group 1, 4 and 8, sq > sk (rows that see no
# key, in tiles of their own at 64 rows and mixed with keyed rows at 128),
# and a non-causal window
SKIP_CASES = [
    (1, 4, 2, 128, 128, 32, True, None, 64, 64),
    (1, 4, 2, 192, 192, 32, True, 48, 64, 64),
    (2, 2, 2, 1, 200, 32, True, None, 1, 40),
    (2, 8, 2, 1, 200, 32, True, None, 1, 40),
    (1, 8, 1, 1, 256, 16, True, None, 1, 64),
    (1, 4, 2, 160, 96, 32, True, None, 32, 32),
    (1, 2, 1, 64, 160, 16, False, 40, 32, 32),
]


@functools.lru_cache(maxsize=None)
def _jax_flash(case, dtype):
    b, hq, hkv, sq, sk, d, causal, window, bq, bk = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=17)
    return np.asarray(jflash(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                             causal=causal, window=window, block_q=bq,
                             block_k=bk), np.float32)


@pytest.mark.parametrize("case", SKIP_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits,tile_q", [(1, 64), (3, 64), (2, 128)])
def test_skipping_and_splitting_match_jax(case, dtype, splits, tile_q):
    """The plain version with the kernels' two steps -- each tile of
    packed rows over its live chunks only, its keys split and merged --
    against the Pallas kernel in interpret mode."""
    b, hq, hkv, sq, sk, d, causal, window, bq, bk = case
    q, k, v = (torch.as_tensor(t).to(getattr(torch, dtype))
               for t in _qkv(b, hq, hkv, sq, sk, d, seed=17))
    got = flash_attention_plain(q, k, v, causal=causal, window=window,
                                block_k=fa.BC, skip_masked=True,
                                splits=splits, tile_q=tile_q)
    assert got.dtype == q.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_flash(case, getattr(jnp, dtype)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("splits,tile_q", [(4, 64), (3, 128)])
def test_keyless_rows_are_the_mean_of_v_under_splits(splits, tile_q):
    """Causal with sq > sk: rows 0..63 see no key.  Their tiles run every
    chunk, and the merge weighs every split by 1, so they stay the mean
    of all of V, as in the Pallas kernel."""
    q, k, v = _qkv(1, 2, 1, 192, 128, 16, seed=19)
    want = np.asarray(jflash(q, k, v, causal=True, block_q=64, block_k=64))
    got = flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                block_k=16, skip_masked=True, splits=splits,
                                tile_q=tile_q).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0, :, :64],
                               np.broadcast_to(v[0, 0].mean(0), (2, 64, 16)),
                               rtol=1e-5, atol=1e-5)


def test_skipping_in_a_tile_with_a_keyless_row_would_change_it(monkeypatch):
    """Why a tile holding a row that sees no key runs every chunk: a
    128-row tile of positions -64..63 over 128 keys, chunks of 16.  Its
    keyed rows need chunks 0..3 only; run over those, its keyless rows
    would average keys 0..63, not all of V.  The keyed rows are the same
    either way."""
    q, k, v = map(torch.as_tensor, _qkv(1, 1, 1, 192, 128, 16, seed=23))
    kw = dict(block_k=16, skip_masked=True, tile_q=128)
    assert fa.live_chunks(0, 128, 192, 128, True, None, bc=16) == (0, 8)
    assert fa.live_chunks(64, 64, 192, 128, True, None, bc=16) == (0, 4)
    right = flash_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(fa, "live_chunks",
                        lambda r0, *args: (0, 4) if r0 == 0 else (0, 8))
    wrong = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(right[0, 0, :64],
                               v[0, 0].mean(0).expand(64, 16), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(wrong[0, 0, :64],
                               v[0, 0, :64].mean(0).expand(64, 16),
                               rtol=1e-5, atol=1e-5)
    assert (wrong[0, 0, :64] - right[0, 0, :64]).abs().max() > 1e-2
    assert torch.equal(wrong[0, 0, 64:128], right[0, 0, 64:128])


@pytest.mark.parametrize("causal,window", [(True, 40), (False, 40),
                                           (True, None)])
def test_skipping_changes_no_bit_of_a_row_that_sees_a_key(causal, window,
                                                          monkeypatch):
    """The same tiles over their live chunks, then over all ten: equal
    bit for bit, as a skipped chunk adds exactly 0 to such a row."""
    q, k, v = map(torch.as_tensor, _qkv(1, 4, 2, 96, 160, 16, seed=29))
    kw = dict(causal=causal, window=window, block_k=16, skip_masked=True,
              tile_q=32)
    live = flash_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(fa, "live_chunks", lambda *args: (0, 10))
    assert torch.equal(live, flash_attention_plain(q, k, v, **kw))


# (r0, rows, sq, sk, causal, window, split, splits) -> (first, count), in
# chunks of 64 keys
LIVE = [
    ((0, 64, 4096, 4096, True, None, 0, 1), (0, 1)),       # first causal tile
    ((4032, 64, 4096, 4096, True, None, 0, 1), (0, 64)),   # last one: all
    ((4032, 64, 4096, 4096, True, 256, 0, 1), (59, 5)),    # a window of 256
    ((0, 4, 1, 32768, True, None, 1, 2), (256, 256)),      # decode, split 1
    ((0, 64, 128, 32, True, None, 0, 1), (0, 1)),          # keyless: all
    ((64, 64, 96, 200, False, 16, 0, 5), (1, 0)),          # empty split
    ((0, 128, 64, 512, True, 64, 0, 1), (6, 2)),           # two heads wrap
]


@pytest.mark.parametrize("args,want", LIVE, ids=str)
def test_live_chunks(args, want):
    r0, rows, sq, sk, causal, window, split, splits = args
    assert fa.live_chunks(r0, rows, sq, sk, causal, window, split,
                          splits) == want


@pytest.mark.parametrize("types,d,which", [
    (("bfloat16",) * 3, 64, "wgmma"), (("bfloat16",) * 3, 80, "wgmma"),
    (("bfloat16",) * 3, 20, "ffma"), (("float32",) * 3, 64, "ffma"),
    (("bfloat16", "bfloat16", "float32"), 64, "ffma"),
    (("float16",) * 3, 64, "ffma")])
def test_attention_dispatch_rule(types, d, which):
    assert fa.variant(*(getattr(torch, t) for t in types), d) == which


# granite-3-2b on an H100 (132 SMs): prefill fills the card, decode's 256
# blocks (under 2 per SM) split into 3 parts, for 4 x 132 blocks or more;
# a mixtral window; one tiny head, split at most once per chunk
@pytest.mark.parametrize("args,want", [
    ((2, 8, 4, 4096, 4096, "wgmma"), (128, 128, 1)),
    ((2, 8, 4, 4096, 4096, "ffma"), (64, 256, 1)),
    ((32, 8, 4, 1, 32768, "wgmma"), (64, 1, 3)),
    ((33, 8, 4, 1, 32768, "wgmma"), (64, 1, 1)),
    ((1, 8, 6, 8192, 8192, "wgmma"), (128, 384, 1)),
    ((1, 1, 1, 1, 100, "ffma"), (64, 1, 2)),
])
def test_launch_plan(args, want):
    assert fa.launch_plan(*args, sms=132) == want


# ------------------------------------------------------------ oracles, ops
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 24)])
def test_ref_attention_matches_jax(causal, window):
    q, k, v = _qkv(2, 4, 2, 32, 48, 16, seed=11)
    want = jref.attention(q, k, v, causal=causal, window=window)
    got = ref.attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                        window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    hi = ref.attention(*(torch.as_tensor(t).double() for t in (q, k, v)),
                       causal=causal, window=window)
    assert hi.dtype == torch.float64
    np.testing.assert_allclose(hi.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ops_attention_both_paths():
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=13)
    want = jops.attention(q, k, v, causal=True, window=32, block_q=32,
                          block_k=32)
    got = ops.attention(q, k, v, causal=True, window=32, block_q=32,
                        block_k=32, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oracle = ops.attention(q, k, v, window=32, use_kernel=False,
                           device="cpu")
    np.testing.assert_array_equal(oracle.numpy(), ref.attention(
        *map(torch.as_tensor, (q, k, v)), window=32).numpy())
    np.testing.assert_allclose(oracle.numpy(), jops.attention(
        q, k, v, window=32, use_pallas=False), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the DSE plan
def _fields(plan):
    d = plan.to_json()
    d.pop("key")
    return d


# (shape, budget) -> blocks, or None where the reference raises
PLANS = {
    ((4096, 4096, 64), None): (4096, 4096),
    ((4096, 4096, 64), H100_BUDGET): (128, 128),
    ((1, 32768, 64), None): (1, 4096),
    ((1, 32768, 64), H100_BUDGET): (1, 128),
    ((8192, 8192, 128), None): (8192, 4096),
    ((8192, 8192, 128), H100_BUDGET): None,
    ((256, 256, 64), None): (256, 256),
    ((256, 256, 64), H100_BUDGET): (128, 128),
}


@pytest.mark.parametrize("case", sorted(PLANS, key=str), ids=str)
def test_select_attention_blocks_matches_the_reference_exactly(case):
    shape, budget = case
    if PLANS[case] is None:
        with pytest.raises(ValueError, match="no tile candidate fits"):
            jdse.select_attention_blocks(*shape, cache=False,
                                         vmem_budget=budget)
        with pytest.raises(ValueError, match="no tile candidate fits"):
            dse.select_attention_blocks(*shape, tier=cost.TPU,
                                        vmem_budget=budget)
        return
    jblocks, jplan = jdse.select_attention_blocks(*shape, cache=False,
                                                  vmem_budget=budget)
    blocks, plan = dse.select_attention_blocks(*shape, tier=cost.TPU,
                                               vmem_budget=budget)
    assert blocks == jblocks == PLANS[case]
    assert _fields(plan) == _fields(jplan)


@pytest.mark.parametrize("arg", ["cache", "measure", "policy", "options"])
def test_select_attention_blocks_refuses_the_tuning_runtime(arg):
    """The selector takes the tuning runtime's arguments (an analytic
    plan is the same with or without a cache, a policy or shape-bucketed
    warm starts, whose first call for a shape explores it)."""
    call = functools.partial(dse.select_attention_blocks, 256, 256, 64,
                             tier=cost.TPU)
    from repro_torch.core import resilience
    from repro_torch.core.options import Options
    if arg == "options":      # bucketing: a miss explores, as without
        blocks, plan = call(options=Options(bucketing=True))
        assert blocks == call(cache=False)[0] and not plan.warm_start
        return
    if arg == "measure":      # validated as the reference validates it
        with pytest.raises(ValueError, match="measure"):
            call(measure="x")
        return
    value = {"cache": False, "policy": resilience.Policy(timeout_s=0)}[arg]
    got = call(**{arg: value})
    want = call(cache=False)
    assert got[0] == want[0]
    assert got[1].to_json() == dict(want[1].to_json(), key=got[1].key)


def test_attention_proxy_evaluates_as_the_reference():
    inp = {"q": _r(0, 16, 8), "k": _r(1, 32, 8), "v": _r(2, 32, 8)}
    got = tex.execute(dse.attention_program(16, 32, 8), inp, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.execute(
        jdse.attention_program(16, 32, 8), inp)), rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_the_reference(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = jconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    for training in (True, False):
        assert got.model_flops(4096, training) == \
            want.model_flops(4096, training)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(configs.SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert configs.skip_reason(got, configs.SHAPES[name]) == \
            jconfigs.skip_reason(want, shape)
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
