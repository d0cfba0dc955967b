"""The port's dense model stack (``repro_torch.models``: ``layers``,
``transformer``, ``model``, ``convert``) on the CPU against the JAX
package's, on the same seeded numpy inputs and the reference's own
JAX-initialised weights carried across by ``convert.params_from_numpy``
(the weights that start at zero get seeded noise, in both packages, so
the norms' gains and Qwen-2's QKV biases are exercised).

Logits of ``forward`` and ``decode_step`` (token by token and as a
prefill block) are held at the reference's tolerances
(``resilience.tolerances``): in float32 at rtol/atol 2e-3, elementwise,
where a real fault cannot hide (the packages agree to about 4e-6); in
bfloat16 at rtol 2e-2 and an atol of 2e-2 x the largest reference logit,
as the SSD's bfloat16 test holds its output.  An elementwise 2e-2 does
not hold in bfloat16: the two frameworks round the products' sums in
other orders, and after two layers 0.3-0.7% of the logits (those near
zero) differ by up to 0.055 on a scale of 4.  Parameter shapes are
equal for every family (the recurrent families' numerics are
``test_torch_ssm.py``'s, the audio and VLM families'
``test_torch_audio_vlm.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import model as jmodel

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import convert, layers, model, transformer

DENSE = ["granite-3-2b", "nemotron-4-15b", "qwen2-72b", "starcoder2-15b"]
TOL = {"bfloat16": 2e-2, "float32": 2e-3}


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, dtype):
    """rtol TOL; atol TOL in float32, TOL x max|want| in bfloat16."""
    want = _np(want)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == "bfloat16" else 1)
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype], atol=atol)


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, w = _r(0, 2, 5, 64), _r(1, 64) * 0.1
    want = jlayers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = layers.rms_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                          torch.as_tensor(w).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("name", ["squared_relu", "gelu", "silu"])
def test_activations_match_jax(name):
    """``gelu`` is jax.nn.gelu's default, the tanh approximation."""
    x = _r(2, 4, 33) * 3
    want = jlayers.activation(name)(jnp.asarray(x))
    got = layers.activation(name)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_activation_refuses_an_unknown_name():
    with pytest.raises(KeyError):
        layers.activation("relu6")


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(theta, per_row):
    """Positions shared by the batch (prefill) or one per row (paged
    decode)."""
    x = _r(3, 2, 6, 4, 16)
    pos = (np.array([[7], [130]]) if per_row
           else np.arange(6)[None] + 3).astype(np.int32)
    if per_row:
        x = x[:, :1]
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_inits_follow_the_reference_statistics():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512), in_axis=0, dtype=torch.float32)
    e = layers.embed_init(gen, (512, 64), dtype=torch.bfloat16)
    assert w.dtype == torch.float32 and e.dtype == torch.bfloat16
    assert abs(float(w.std()) - 256 ** -0.5) < 0.01 * 256 ** -0.5 * 10
    assert abs(float(e.float().std()) - 0.02) < 0.002


# -------------------------------------------------------------- models
def _params(arch, dtype, seed=0):
    """The reference's params for ``arch`` SMOKE in ``dtype``, the
    zero-initialised ones replaced by seeded noise, as numpy arrays and
    as the port's tensors."""
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    shapes = jmodel.param_shapes(jcfg)
    rng = np.random.RandomState(seed + 1)
    for name, (shape, kind) in sorted(shapes.items()):
        if kind == "zeros":
            jp[name] = jnp.asarray(rng.randn(*shape) * 0.1, dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch, dtype):
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 12, 3)
    want = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = model.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape and str(got.dtype) == f"torch.{dtype}"
    _close(got, want, dtype)


def test_forward_takes_several_query_blocks(monkeypatch):
    """``_sdpa_chunked`` over 3 query blocks of 4 (its q-block grain
    cut to 4): the same logits as one block, as the reference's."""
    jcfg, cfg, jp, tp = _params("granite-3-2b", "float32")
    toks = _tokens(cfg, 1, 12, 4)
    whole = model.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    monkeypatch.setattr(transformer, "ATTN_CHUNK", 4)
    from repro.models import transformer as jtransformer
    monkeypatch.setattr(jtransformer, "ATTN_CHUNK", 4)
    want = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = model.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_and_cache_match_jax(arch, dtype):
    """A 5-token prefill block, then 4 single-token steps."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 9, 5)
    jc = jmodel.init_cache(jcfg, 2, 12)
    tc = model.init_cache(cfg, 2, 12, device="cpu")
    steps = [(0, 5)] + [(i, i + 1) for i in range(5, 9)]
    for i0, i1 in steps:
        want, jc = jmodel.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, i0:i1]),
                                      jnp.int32(i0))
        got, tc = model.decode_step(tp, cfg, tc,
                                    torch.as_tensor(toks[:, i0:i1]), i0)
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype)


def test_decode_step_writes_the_ring_buffer_of_a_sliding_window():
    """A window of 4 over 10 tokens: the ring of 4 slots wraps twice."""
    jcfg, cfg, jp, tp = _params("granite-3-2b", "float32")
    jcfg, cfg = jcfg.with_(sliding_window=4), cfg.with_(sliding_window=4)
    toks = _tokens(cfg, 1, 10, 6)
    jc = jmodel.init_cache(jcfg, 1, 10)
    tc = model.init_cache(cfg, 1, 10, device="cpu")
    assert tc["k"].shape[3] == jc["k"].shape[3] == 4
    for i in range(10):
        want, jc = jmodel.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i))
        got, tc = model.decode_step(tp, cfg, tc,
                                    torch.as_tensor(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_match_jax_or_raise(arch):
    """Every family of ``ARCHS`` has the reference's parameter shapes
    (audio and VLM included since their slice); a family the reference
    does not define raises."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    assert model.param_shapes(cfg) == jmodel.param_shapes(jcfg)
    assert model.param_shapes(get_config(arch)) \
        == jmodel.param_shapes(jget_config(arch))
    bad = cfg.with_(family="speech")
    for fn in (lambda: model.param_shapes(bad),
               lambda: model.init_params(bad, 0, "cpu"),
               lambda: model.init_cache(bad, 1, 8, device="cpu"),
               lambda: model.forward({}, bad, {"tokens": torch.zeros(
                   (1, 2), dtype=torch.int32)})):
        with pytest.raises(NotImplementedError, match="no speech family"):
            fn()


def test_init_params_is_seeded_and_typed():
    cfg = get_config("granite-3-2b", smoke=True)
    a = model.init_params(cfg, 3, "cpu")
    b = model.init_params(cfg, 3, "cpu")
    c = model.init_params(cfg, 4, "cpu")
    assert sorted(a) == sorted(model.param_shapes(cfg))
    for name, (shape, kind) in model.param_shapes(cfg).items():
        assert tuple(a[name].shape) == shape
        assert a[name].dtype == torch.bfloat16
        assert torch.equal(a[name], b[name])
        if kind == "zeros":
            assert not bool(a[name].any())
        else:
            assert not torch.equal(a[name], c[name])
    assert sum(t.numel() for t in a.values()) == cfg.param_count() + \
        (cfg.padded_vocab - cfg.vocab) * 2 * cfg.d_model


def test_convert_refuses_a_parameter_set_of_another_config():
    jcfg, cfg, jp, _ = _params("granite-3-2b", "bfloat16")
    host = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(ValueError, match="differ"):
        convert.params_from_numpy({**host, "extra": host["ln1"]}, cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy({**host, "ln1": host["ln2"][:1]}, cfg,
                                  "cpu")


def test_mask_vocab_pad_matches_jax():
    cfg, jcfg = get_config("granite-3-2b"), jget_config("granite-3-2b")
    logits = _r(8, 2, 1, cfg.padded_vocab)
    want = jmodel.mask_vocab_pad(jnp.asarray(logits), jcfg)
    got = model.mask_vocab_pad(torch.as_tensor(logits), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[..., cfg.vocab:].max()) == float(np.float32(-1e30))


def test_models_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-3-2b", smoke=True)
    for fn in (lambda: model.init_params(cfg, 0),
               lambda: model.init_cache(cfg, 1, 8),
               lambda: convert.params_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
