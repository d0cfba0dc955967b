"""The port's attention kernel layer on the CPU against the JAX package's:
``repro_torch.kernels.flash_attention`` (its plain version, ``device="cpu"``)
against the Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py`` (float32 2e-4, the reference tests' tolerance),
in bfloat16 (2e-2), at a decode row, at head dim 80 and with ``sq > sk``,
whose rows that see no key are the mean of V in both; ``ref.attention``
and ``ops.attention`` against the JAX ones; ``select_attention_blocks``
exactly as the reference's (``cache=False``) under ``cost.TPU``, at the
TPU's 16 MiB and the H100's 232,448 B, raising where it raises; and the
model configurations (``repro_torch.configs``) field by field, with their
parameter and FLOP counts.
"""
import dataclasses

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
    with pytest.raises(NotImplementedError, match="tuning-runtime"):
        dse.select_attention_blocks(256, 256, 64, tier=cost.TPU,
                                    **{arg: "x"})


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
