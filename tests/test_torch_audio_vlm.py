"""The port's audio (MusicGen) and VLM (InternVL) families on the CPU
against the JAX package's, on the same seeded numpy inputs and the
reference's own JAX-initialised weights carried across by
``convert.params_from_numpy`` (the weights that start at zero get
seeded noise, in both packages).

MusicGen sums its codebooks' embeddings ``(n_cb, V, d)`` and emits one
head per codebook ``(n_cb, d, V)``: logits ``(B, S, n_cb, V)``.  InternVL
puts the stubbed frontend's ``prefix_embeds`` ahead of its text.  Logits
of ``forward`` (with and without a prefix) and ``decode_step`` are held
at the reference's tolerances: float32 at rtol/atol 2e-3 elementwise,
bfloat16 at rtol 2e-2 and an atol of 2e-2 x the largest reference logit.
``serve`` on the dense cache returns the reference's tokens, codebook 0
as it reports (float32: identical; bfloat16: identical up to a
request's first step where the reference's own logits tie at the top
within the bfloat16 tolerance); ``serve_continuous`` refuses both
families as the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import transformer as jtransformer

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve, steps
from repro_torch.models import convert, model, transformer

FAMILIES = ["musicgen-medium", "internvl2-1b"]
TOL = {"bfloat16": 2e-2, "float32": 2e-3}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == "bfloat16" else 1)
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype], atol=atol)


def _params(arch, dtype, seed=0):
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    for name, (shape, kind) in sorted(jmodel.param_shapes(jcfg).items()):
        if kind == "zeros":
            jp[name] = jnp.asarray(rng.randn(*shape) * 0.1, dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, b, s, seed):
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s) + ncb) \
        .astype(np.int32)


def _prefix(cfg, b, seed):
    return np.random.RandomState(seed).randn(
        b, cfg.frontend_tokens or 3, cfg.d_model).astype(np.float32)


# -------------------------------------------------------------- forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_jax(arch, dtype):
    """Through ``model.forward``: the VLM's batch carries its prefix."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 12, 3)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.family == "vlm":
        pre = _prefix(cfg, 2, 4)
        jb["prefix_embeds"] = jnp.asarray(pre)
        tb["prefix_embeds"] = torch.as_tensor(pre)
    want = jmodel.forward(jp, jcfg, jb)
    got = model.forward(tp, cfg, tb)
    s = 12 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert got.shape == want.shape == (2, s) + ncb + (cfg.padded_vocab,)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, want, dtype)


@pytest.mark.parametrize("with_prefix", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_transformer_forward_with_and_without_a_prefix(arch, with_prefix):
    """``transformer.forward(prefix_embeds=)``: the prefix (float32 here,
    cast to the model's type) goes ahead of the tokens, for either
    family; without one, the tokens alone."""
    jcfg, cfg, jp, tp = _params(arch, "float32")
    toks = _tokens(cfg, 2, 9, 5)
    pre = _prefix(cfg, 2, 6) if with_prefix else None
    want = jtransformer.forward(
        jp, jcfg, jnp.asarray(toks),
        prefix_embeds=None if pre is None else jnp.asarray(pre))
    got = transformer.forward(
        tp, cfg, torch.as_tensor(toks),
        prefix_embeds=None if pre is None else torch.as_tensor(pre))
    assert got.shape[1] == 9 + (0 if pre is None else pre.shape[1])
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_logits_and_cache_match_jax(arch, dtype):
    """A 5-token prefill block, then 4 single-token steps; codebook
    tokens are (B, S, n_cb)."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 9, 7)
    jc = jmodel.init_cache(jcfg, 2, 12)
    tc = model.init_cache(cfg, 2, 12, device="cpu")
    for i0, i1 in [(0, 5)] + [(i, i + 1) for i in range(5, 9)]:
        want, jc = jmodel.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, i0:i1]),
                                      jnp.int32(i0))
        got, tc = model.decode_step(tp, cfg, tc,
                                    torch.as_tensor(toks[:, i0:i1]), i0)
        assert got.shape == want.shape
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype)


def test_greedy_gives_one_token_per_codebook():
    """``argmax(logits[:, -1], -1)``: (B, n_cb), pad vocab masked."""
    cfg = get_config("musicgen-medium", smoke=True)
    logits = torch.as_tensor(np.random.RandomState(0).randn(
        3, 4, cfg.n_codebooks, cfg.padded_vocab).astype(np.float32))
    got = steps.greedy(logits, cfg)
    want = np.argmax(np.asarray(jmodel.mask_vocab_pad(
        jnp.asarray(logits.numpy()), jget_config("musicgen-medium",
                                                 smoke=True)))[:, -1], -1)
    assert got.shape == (3, cfg.n_codebooks) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_vocab_pad_covers_codebook_logits():
    cfg = get_config("musicgen-medium", smoke=True).with_(vocab_pad=3)
    jcfg = jget_config("musicgen-medium", smoke=True).with_(vocab_pad=3)
    x = np.random.RandomState(1).randn(2, 3, cfg.n_codebooks,
                                       cfg.padded_vocab).astype(np.float32)
    np.testing.assert_array_equal(
        model.mask_vocab_pad(torch.as_tensor(x), cfg).numpy(),
        np.asarray(jmodel.mask_vocab_pad(jnp.asarray(x), jcfg)))


def test_convert_carries_the_codebook_tables_bit_for_bit():
    jcfg, cfg, jp, tp = _params("musicgen-medium", "bfloat16")
    assert tuple(tp["embed"].shape) == (cfg.n_codebooks, cfg.padded_vocab,
                                        cfg.d_model)
    assert tuple(tp["lm_head"].shape) == (cfg.n_codebooks, cfg.d_model,
                                          cfg.padded_vocab)
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(_np(tp[name]), _np(jp[name]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_no_family_of_the_reference_raises(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    for cfg in (get_config(arch), get_config(arch, smoke=True)):
        transformer.check_family(cfg)


# -------------------------------------------------------------- serving
def _reference_row(jp, jcfg, prompt, toks):
    """The reference's codebook-0 logits after ``prompt`` and ``toks``
    (teacher forced, one forward)."""
    seq = np.concatenate([prompt, toks], 0)[None].astype(np.int32)
    logits = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(seq)})
    row = jmodel.mask_vocab_pad(logits, jcfg)[0, -1]
    if jcfg.n_codebooks:
        row = row[0]
    return torch.as_tensor(np.array(row.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_matches_jax(arch, dtype, monkeypatch):
    """Mixed prompt lengths on the dense cache, regrouped, in input
    order: the reference's codebook-0 tokens on the same weights; every
    codebook's tokens come back in ``stats_out``."""
    lens, gen = (6, 4, 6), 4
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))   # serve's own
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    want = jserve.serve(arch, True, 3, 6, gen, prompt_lens=lens)
    stats = {}
    got = serve.serve(arch, True, 3, 6, gen, prompt_lens=lens, params=tp,
                      device="cpu", stats_out=stats)
    assert got.shape == (3, gen)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert stats["first_tokens"].shape == (3,) + ncb
    if ncb:
        np.testing.assert_array_equal(stats["codebook_tokens"][..., 0], got)
        assert stats["codebook_tokens"].shape == (3, gen) + ncb
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    pool = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (3, max(lens)) + ncb)
    ties = 0
    for r, ln in enumerate(lens):
        diff = np.flatnonzero(got[r] != want[r])
        if not diff.size:
            continue
        t = int(diff[0])
        done = stats["codebook_tokens"][r, :t] if ncb else want[r, :t]
        row = _reference_row(jp, jcfg, pool[r, :ln], done)
        assert serve.near_best(row, int(got[r, t]), dtype), (r, t)
        ties += 1
    assert ties <= 1, ties


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_continuous_refuses_both_families(arch):
    with pytest.raises(NotImplementedError, match="dense/moe"):
        serve.serve_continuous(arch, True, 2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="dense/moe"):
        jserve.serve_continuous(arch, True, 2, 2)
