"""The port's SSM (Mamba-2) and hybrid (Zamba-2) families on the CPU
against the JAX package's, on the same seeded numpy inputs and the
reference's own JAX-initialised weights carried across by
``convert.params_from_numpy`` (the weights that start at zero get seeded
noise, in both packages, each in its own type: ``A_log``, ``D`` and
``dt_bias`` stay float32).

``ssd_chunked`` (y and the final state), ``causal_conv1d``, ``forward``
logits and ``decode_step`` logits and states are held at the reference's
tolerances (``resilience.tolerances``): float32 at rtol/atol 2e-3,
elementwise; bfloat16 at rtol 2e-2 and an atol of 2e-2 x the largest
reference logit, or, where larger, the reference's own bfloat16 error:
the largest gap between its bfloat16 and float32 logits on the same
weights.  The hybrid needs the latter: a one-ulp difference of a float32
sum in the chunked SSD flips a bfloat16 rounding, which the next layers
carry to a few bfloat16 ulps of the logits (0.16 on a scale of 4, where
the reference's own bfloat16 error is 0.19).  The cache prefill (a token
scan through ``decode_step``) equals decoding token by token; ``serve``
returns the reference's tokens (float32: identical; bfloat16: identical
up to a request's first step where the reference's own logits tie at the
top within the bfloat16 tolerance); ``serve_continuous`` refuses both
families as the reference does; full-width parameter shapes are the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm

from repro_torch.configs import get_config
from repro_torch.launch import serve, steps
from repro_torch.models import convert, hybrid, layers, model, ssm
from repro_torch.models.convert import tensor_from_numpy

ARCHS = ["mamba2-370m", "zamba2-2.7b"]
TOL = {"bfloat16": 2e-2, "float32": 2e-3}
DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _t(a, dtype):
    """A reference array as the port's tensor, bit for bit."""
    return tensor_from_numpy(np.asarray(a), DT[dtype], "cpu")


def _close(got, want, dtype, floor=0.0):
    """rtol TOL; atol TOL in float32, max(TOL x max|want|, floor) in
    bfloat16."""
    want = _np(want)
    atol = TOL[dtype]
    if dtype == "bfloat16":
        atol = max(atol * np.abs(want).max(), floor)
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype], atol=atol)


def _params(arch, dtype, seed=0):
    """The reference's params for ``arch`` SMOKE in ``dtype``, the
    zero-initialised ones replaced by seeded noise in their own types,
    and the port's tensors."""
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    for name, (shape, kind) in sorted(jmodel.param_shapes(jcfg).items()):
        if kind == "zeros":
            noise = rng.randn(*shape) * 0.1
            if name == "m_A_log":
                noise -= 0.5
            jp[name] = jnp.asarray(noise, jp[name].dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _own_bf16_error(jp, jcfg, toks) -> float:
    """The reference's bfloat16 logits against its float32 logits on the
    same (bfloat16) weights: its own bfloat16 error."""
    b16 = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    f32 = jmodel.forward({k: v.astype(jnp.float32) for k, v in jp.items()},
                         jcfg.with_(dtype="float32"),
                         {"tokens": jnp.asarray(toks)})
    return float(np.abs(_np(b16) - _np(f32)).max())


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(dtype, with_state):
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 7, 24), dtype)
    w = jnp.asarray(rng.randn(4, 24) * 0.5, dtype)
    st = jnp.asarray(rng.randn(2, 3, 24), dtype) if with_state else None
    jy, jst = jlayers.causal_conv1d(x, w, st)
    y, new = layers.causal_conv1d(_t(x, dtype), _t(w, dtype),
                                  None if st is None else _t(st, dtype))
    assert y.dtype == DT[dtype] and new.shape == (2, 3, 24)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_array_equal(_np(new), _np(jst))   # the last K-1 inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_is_the_references_per_operation(dtype):
    x = jnp.asarray(np.random.RandomState(4).randn(4096) * 6, dtype)
    got, want = layers.silu(_t(x, dtype)), jax.nn.silu(x)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-6)


# (b, s, h, dh, n, chunk): one chunk, several, a chunk past the sequence
SSD = [(2, 16, 4, 32, 16, None), (1, 128, 2, 16, 8, None),
       (2, 96, 3, 8, 4, 32), (1, 8, 2, 4, 4, 64)]


@pytest.mark.parametrize("case", SSD, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(case, dtype):
    """y and the final state, with the reference's bfloat16 rounding of
    the intra-chunk operands in both types."""
    b, s, h, dh, n, chunk = case
    rng = np.random.RandomState(s + n)
    x = jnp.asarray(rng.randn(b, s, h, dh), dtype)
    dt = jnp.asarray(np.log1p(np.exp(rng.randn(b, s, h))) * 0.5, jnp.float32)
    A = jnp.asarray(-np.exp(rng.randn(h) * 0.3), jnp.float32)
    B = jnp.asarray(rng.randn(b, s, n), dtype)
    C = jnp.asarray(rng.randn(b, s, n), dtype)
    jy, jh = jssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    y, hfin = ssm.ssd_chunked(_t(x, dtype), _t(dt, "float32"),
                              _t(A, "float32"), _t(B, dtype), _t(C, dtype),
                              chunk=chunk)
    assert y.dtype == DT[dtype] and hfin.dtype == torch.float32
    _close(y, jy, dtype)
    np.testing.assert_allclose(hfin.numpy(), _np(jh), rtol=2e-3, atol=2e-3)


def test_ssd_chunked_refuses_a_ragged_sequence():
    x = torch.zeros((1, 96, 1, 4))
    with pytest.raises(ValueError, match="divide"):
        ssm.ssd_chunked(x, torch.ones((1, 96, 1)), -torch.ones(1),
                        torch.zeros((1, 96, 4)), torch.zeros((1, 96, 4)))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_jax_at_full_width(arch):
    for smoke in (True, False):
        assert model.param_shapes(get_config(arch, smoke=smoke)) \
            == jmodel.param_shapes(jget_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_keep_the_references_types(arch):
    """``init_params`` and ``convert`` keep A_log, D and dt_bias float32
    and the rest in the config's type, as the reference does; the
    decays start stable."""
    _, cfg, jp, tp = _params(arch, "bfloat16")
    for name, t in tp.items():
        assert str(t.dtype).split(".")[1] == str(jp[name].dtype), name
    own = model.init_params(cfg, 0, "cpu")
    assert {k: v.dtype for k, v in own.items()} \
        == {k: v.dtype for k, v in tp.items()}
    assert bool((own["m_A_log"] == -0.5).all())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(arch, dtype):
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 16, 5)
    want = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = model.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == DT[dtype] and got.shape == (2, 16, cfg.padded_vocab)
    floor = _own_bf16_error(jp, jcfg, toks) if dtype == "bfloat16" else 0
    _close(got, want, dtype, floor)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_state_match_jax(arch, dtype):
    """Token by token through ``decode_step`` (the recurrent branch, and
    the hybrid's KV slots): every step's logits and the final cache."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 12, 6)
    floor = _own_bf16_error(jp, jcfg, toks) if dtype == "bfloat16" else 0
    jcache = jmodel.init_cache(jcfg, 2, 16)
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    step = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, jcfg, c, t, i))
    for i in range(toks.shape[1]):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        got, cache = model.decode_step(tp, cfg, cache,
                                       torch.as_tensor(toks[:, i:i + 1]), i)
        _close(got, want, dtype, floor)
    assert cache["ssm"]["ssm"].dtype == torch.float32
    assert cache["ssm"]["conv"].dtype == DT[dtype]
    np.testing.assert_allclose(cache["ssm"]["ssm"].numpy(),
                               _np(jcache["ssm"]["ssm"]),
                               rtol=TOL[dtype], atol=TOL[dtype] * max(
                                   1.0, np.abs(_np(jcache["ssm"]["ssm"]))
                                   .max()))
    if arch == "zamba2-2.7b":
        assert cache["k"].shape == jcache["k"].shape \
            == (hybrid.n_attn_apps(cfg), 2, cfg.n_kv_heads, 16, cfg.head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_forward(arch):
    """The recurrent form carries on where the chunked form leaves off:
    decoding the prompt token by token gives forward's last logits, at
    bfloat16's tolerance even in float32 (the chunked form rounds its
    intra-chunk operands to bfloat16, as the reference's does)."""
    _, cfg, _, tp = _params(arch, "float32")
    toks = torch.as_tensor(_tokens(cfg, 2, 16, 7))
    full = model.forward(tp, cfg, {"tokens": toks})
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    for i in range(16):
        logits, cache = model.decode_step(tp, cfg, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_prefill_matches_token_by_token(arch):
    """The recurrent prefill scans the prompt through ``decode_step``: its
    greedy token and cache equal token-by-token decoding (the reference's
    ``tests/test_serving.py`` case)."""
    cfg = get_config(arch, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    b, s, room = 2, 8, 4
    prompt = torch.as_tensor(_tokens(cfg, b, s, 1))
    prefill = steps.make_cache_prefill_step(cfg)
    nxt_a, cache_a = prefill(params, model.init_cache(cfg, b, s + room,
                                                      device="cpu"),
                             prompt, 0)
    cache_b = model.init_cache(cfg, b, s + room, device="cpu")
    for i in range(s):
        logits, cache_b = model.decode_step(params, cfg, cache_b,
                                            prompt[:, i:i + 1], i)
    assert torch.equal(nxt_a, steps.greedy(logits, cfg))
    flat_a = jax.tree_util.tree_leaves(cache_a)
    flat_b = jax.tree_util.tree_leaves(cache_b)
    assert len(flat_a) == len(flat_b) == (2 if arch == "mamba2-370m" else 4)
    for a, c in zip(flat_a, flat_b):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_prefill_matches_the_references(arch):
    jcfg, cfg, jp, tp = _params(arch, "float32")
    prompt = _tokens(cfg, 2, 8, 2)
    jnxt, jcache = jax.jit(jsteps.make_cache_prefill_step(jcfg))(
        jp, jmodel.init_cache(jcfg, 2, 12), jnp.asarray(prompt),
        jnp.int32(0))
    nxt, cache = steps.make_cache_prefill_step(cfg)(
        tp, model.init_cache(cfg, 2, 12, device="cpu"),
        torch.as_tensor(prompt), 0)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_allclose(cache["ssm"]["ssm"].numpy(),
                               _np(jcache["ssm"]["ssm"]), rtol=2e-3,
                               atol=2e-3)


# -------------------------------------------------------------- serving
def _reference_row(jp, jcfg, prompt, served):
    """The reference's greedy logits (pad vocab masked, float32) for the
    served token after ``served``: its decode steps over the prompt, the
    prompt's greedy token, then ``served``."""
    step = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, jcfg, c, t, i))
    seq = [int(x) for x in prompt]
    cache = jmodel.init_cache(jcfg, 1, len(prompt) + len(served) + 2)
    logits = None
    i = 0
    while True:
        logits, cache = step(jp, cache, jnp.asarray([[seq[i]]], jnp.int32),
                             jnp.int32(i))
        i += 1
        if i == len(seq):
            if len(seq) == len(prompt):
                seq.append(int(jnp.argmax(jmodel.mask_vocab_pad(
                    logits, jcfg)[0, -1])))
                seq += [int(x) for x in served]
            else:
                break
    return torch.as_tensor(np.array(jmodel.mask_vocab_pad(
        logits, jcfg)[0, -1].astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_jax(arch, dtype, monkeypatch):
    """Mixed prompt lengths, regrouped, in input order: the reference's
    tokens on the same weights (bfloat16: up to a tie of the reference's
    own logits, past which a request's context differs)."""
    lens, gen = (6, 4, 6), 4
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    want = jserve.serve(arch, True, 3, 6, gen, prompt_lens=lens)
    got = serve.serve(arch, True, 3, 6, gen, prompt_lens=lens, params=tp,
                      device="cpu")
    assert got.shape == (3, gen)
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
        row = _reference_row(jp, jcfg, pool[r, :ln], want[r, :t])
        assert serve.near_best(row, int(got[r, t]), dtype), (r, t)
        ties += 1
    assert ties <= 1, ties


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_continuous_refuses_the_recurrent_families(arch):
    """As the reference: continuous paged serving is dense/MoE only."""
    with pytest.raises(NotImplementedError, match="dense/moe"):
        serve.serve_continuous(arch, True, 2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="dense/moe"):
        jserve.serve_continuous(arch, True, 2, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_length_is_the_whole_context(arch):
    """The recurrent scan has no ring: a prompt prefills in one chunk."""
    cfg = get_config(arch, smoke=True)
    assert serve._ring_len(cfg, 77) == 77 \
        == jserve._ring_len(jget_config(arch, smoke=True), 77)


def test_serve_runs_without_a_given_device_only_on_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve("mamba2-370m", True, 1, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(get_config("zamba2-2.7b", smoke=True), 1, 4)
