"""The port's serving path (``repro_torch.launch``: ``steps``, ``serve``)
on the CPU: the one-call block prefill equals the token-by-token oracle,
mixed prompt lengths keep their order, zero-length prompts are refused,
and continuous paged serving of granite-3-2b SMOKE returns every
request's tokens identical to the port's dense ``decode_step`` oracle and
to the JAX package's ``serve_continuous`` on the same weights (carried
across with ``convert.params_from_numpy``): in bfloat16 as the reference's
test runs it and in float32, where a tie at the top cannot decide a
token.  Certification raises on a faulty kernel instead of falling back.
On the card's tier the paged plan is the kernel's own, so serving plans
at a context where the reference's search raises at the card's budget.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, dse
from repro_torch.launch import serve, steps
from repro_torch.models import convert, model

ARCH = "granite-3-2b"


def _prompt(cfg, b, s, seed):
    return torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, (b, s)), dtype=torch.int32)


def test_cache_prefill_matches_token_by_token():
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    b, s, room = 2, 8, 4
    prompt = _prompt(cfg, b, s, 1)
    prefill = steps.make_cache_prefill_step(cfg)
    nxt_a, cache_a = prefill(params, model.init_cache(cfg, b, s + room,
                                                      device="cpu"),
                             prompt, 0)
    cache_b = model.init_cache(cfg, b, s + room, device="cpu")
    for i in range(s):
        logits, cache_b = model.decode_step(params, cfg, cache_b,
                                            prompt[:, i:i + 1], i)
    assert torch.equal(nxt_a, steps.greedy(logits, cfg))
    for name in ("k", "v"):
        torch.testing.assert_close(cache_a[name].float(),
                                   cache_b[name].float(), rtol=2e-4,
                                   atol=2e-4)


def test_prefill_chunks_at_ring_boundary():
    """A prompt longer than a sliding window's ring serves through
    ``_prefill``'s chunking (a block write must not wrap the ring)."""
    cfg = get_config(ARCH, smoke=True).with_(sliding_window=5)
    params = model.init_params(cfg, 0, "cpu")
    total = 12
    ring = serve._ring_len(cfg, total)
    assert ring == 5
    prompt = _prompt(cfg, 1, ring + 3, 2)
    prefill = steps.make_cache_prefill_step(cfg)
    nxt_a, _ = serve._prefill(prefill, params,
                              model.init_cache(cfg, 1, total, device="cpu"),
                              prompt, ring)
    cache_b = model.init_cache(cfg, 1, total, device="cpu")
    for i in range(prompt.shape[1]):
        logits, cache_b = model.decode_step(params, cfg, cache_b,
                                            prompt[:, i:i + 1], i)
    assert torch.equal(nxt_a, steps.greedy(logits, cfg))


def test_serve_mixed_prompt_lengths_preserve_order():
    """Requests re-grouped by prompt length come back in input order:
    the rows sharing the uniform run's length generate identical tokens,
    whichever group they decoded in."""
    uniform = serve.serve(ARCH, True, 3, 6, 2, device="cpu")
    stats = {}
    mixed = serve.serve(ARCH, True, 3, 6, 2, prompt_lens=(6, 4, 6),
                        stats_out=stats, device="cpu")
    assert mixed.shape == (3, 2)
    np.testing.assert_array_equal(mixed[[0, 2]], uniform[[0, 2]])
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_serve_matches_the_reference_on_the_same_weights():
    jcfg = jget_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    want = jserve.serve(ARCH, True, 3, 6, 3, prompt_lens=(6, 4, 6))
    got = serve.serve(ARCH, True, 3, 6, 3, prompt_lens=(6, 4, 6), params=tp,
                      device="cpu")
    np.testing.assert_array_equal(got, want)


def test_zero_length_prompts_rejected():
    with pytest.raises(ValueError, match="positive"):
        serve.serve(ARCH, True, 3, 6, 2, prompt_lens=(6, 0, 6),
                    device="cpu")
    with pytest.raises(ValueError, match="positive"):
        serve.serve_continuous(ARCH, True, 2, 2, prompt_lens=(3, 0),
                               device="cpu")
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    prefill = steps.make_cache_prefill_step(cfg)
    with pytest.raises(ValueError, match="zero-length"):
        serve._prefill(prefill, params,
                       model.init_cache(cfg, 1, 4, device="cpu"),
                       torch.zeros((1, 0), dtype=torch.int32), 4)


def _dense_oracle(cfg, params, lens, gen, cmax, seed=0):
    """Every request's greedy tokens from the dense ``decode_step``,
    token by token, over the serving trace's prompts."""
    pool = np.random.RandomState(seed).randint(0, cfg.vocab,
                                               (len(lens), max(lens)))
    step = steps.make_serve_step(cfg)
    out = []
    for r, ln in enumerate(lens):
        cache = model.init_cache(cfg, 1, cmax, device="cpu")
        nxt, want = None, []
        for i in range(ln + gen):
            tok = (torch.as_tensor(pool[r:r + 1, i:i + 1], dtype=torch.int32)
                   if i < ln else nxt.reshape(1, 1))
            nxt, cache = step(params, cache, tok, i)
            if i >= ln:
                want.append(int(nxt[0]))
        out.append(want)
    return np.array(out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_continuous_matches_oracle_and_reference(dtype, monkeypatch):
    """Continuous batching over the paged pool (admit/evict churn, more
    requests than slots, the kernel's path, certification on): every
    request's tokens in input order, identical to the dense oracle and to
    the reference's ``serve_continuous`` on the same weights."""
    lens, gen, slots = (3, 5, 9, 4), 3, 2
    jcfg = jget_config(ARCH, smoke=True).with_(dtype=dtype)
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True).with_(dtype=dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    before = cc.lower_paged_decode.launches
    toks, stats = serve.serve_continuous(ARCH, True, slots, gen,
                                         prompt_lens=lens, params=tp,
                                         device="cpu", dtype=dtype)
    assert cc.lower_paged_decode.launches == before   # the plain version
    assert toks.shape == (len(lens), gen)
    assert stats["certified"] is True and stats["use_pallas"]
    assert stats["admitted"] == stats["evicted"] == len(lens)
    assert 0 < stats["occupancy"] <= 1
    assert 0 < stats["modeled_paged_traffic_words"] \
        < stats["modeled_dense_traffic_words"]
    ps = stats["page_size"]
    want, jstats = jserve.serve_continuous(ARCH, True, slots, gen,
                                           prompt_lens=lens, page_size=ps,
                                           layout=stats["layout"])
    np.testing.assert_array_equal(toks, want)
    assert {k: stats[k] for k in ("steps", "admitted", "evicted",
                                  "occupancy", "modeled_paged_traffic_words",
                                  "modeled_dense_traffic_words")} == \
        {k: jstats[k] for k in ("steps", "admitted", "evicted", "occupancy",
                                "modeled_paged_traffic_words",
                                "modeled_dense_traffic_words")}
    assert sorted(stats) == sorted(jstats)
    cmax = -(-(max(lens) + gen) // ps) * ps
    np.testing.assert_array_equal(toks, _dense_oracle(cfg, tp, lens, gen,
                                                      cmax))


@pytest.mark.parametrize("layout", ["split", "fused"])
def test_serve_continuous_reference_path_and_layouts(layout):
    lens, gen = (4, 7, 2), 3
    cfg = get_config(ARCH, smoke=True)
    ref, _ = serve.serve_continuous(ARCH, True, 2, gen, prompt_lens=lens,
                                    layout=layout, page_size=4,
                                    use_kernel=False, device="cpu")
    got, stats = serve.serve_continuous(ARCH, True, 2, gen, prompt_lens=lens,
                                        layout=layout, page_size=4,
                                        device="cpu")
    assert stats["layout"] == layout and stats["page_size"] == 4
    np.testing.assert_array_equal(got, ref)
    params = model.init_params(cfg, 0, "cpu")
    np.testing.assert_array_equal(got, _dense_oracle(cfg, params, lens, gen,
                                                     12))


def test_certification_raises_on_a_faulty_kernel(monkeypatch):
    """A kernel that skips the append fails certification: serving
    raises instead of falling back to the reference path."""
    real = cc.paged_decode_plain

    def no_append(q, new_k, new_v, pools, *args, **kw):
        return real(q, torch.zeros_like(new_k), torch.zeros_like(new_v),
                    pools, *args, **kw)

    monkeypatch.setattr(cc, "paged_decode_plain", no_append)
    with pytest.raises(RuntimeError, match="certification"):
        serve.serve_continuous(ARCH, True, 2, 3, prompt_lens=(4, 6),
                               device="cpu")
    toks, stats = serve.serve_continuous(ARCH, True, 2, 3,
                                         prompt_lens=(4, 6), certify=False,
                                         use_kernel=False, device="cpu")
    assert stats["certified"] is None and not stats["use_pallas"]


def test_serving_raises_where_the_dse_has_no_plan():
    """On the card's tier the paged plan is the kernel's (its chunk, its
    ring, its shared bytes), so a context of 960, where the reference's
    search has no plan at the card's budget, now plans and serves; under
    ``cost.TPU`` at that budget the reference's raise is reproduced.
    Where the kernel cannot take the shape (a head dim past its DMAX)
    the DSE has no plan and serving raises rather than guess one."""
    toks, stats = serve.serve_continuous(ARCH, True, 2, 64,
                                         prompt_lens=(896, 5), device="cpu")
    assert toks.shape == (2, 64) and stats["certified"] is True
    assert (stats["block"], stats["depth"]) == (cc.PD_KC, cc.PD_STAGES)
    with pytest.raises(ValueError, match="no tile candidate fits"):
        dse.select_paged_decode_blocks(960, 64, tier=cost.TPU,
                                       vmem_budget=cost.H100_SXM.onchip_bytes)
    wide = get_config(ARCH, smoke=True).with_(head_dim=2 * cc.PD_DMAX)
    with pytest.raises(ValueError, match="no tile candidate fits"):
        serve._serve_continuous(wide, 2, 4, prompt_lens=(5, 3),
                                device="cpu")


def test_serving_refuses_what_this_slice_does_not_run(monkeypatch):
    """Bucketed serving runs and serves the same tokens (the plans are
    provenance); continuous paged serving refuses the recurrent families
    as the reference does; without a card and without ``device="cpu"``
    serving raises."""
    stats = {}
    np.testing.assert_array_equal(
        serve.serve(ARCH, True, 2, 4, 2, bucketing=True, device="cpu",
                    stats_out=stats),
        serve.serve(ARCH, True, 2, 4, 2, device="cpu"))
    assert stats["plans"][-1]["bucket_stats"]["misses"] == 1
    toks, _ = serve.serve_continuous(ARCH, True, 2, 2, bucketing=True,
                                     device="cpu")
    np.testing.assert_array_equal(
        toks, serve.serve_continuous(ARCH, True, 2, 2, device="cpu")[0])
    with pytest.raises(NotImplementedError, match="dense/moe"):
        serve.serve_continuous("mamba2-370m", True, 2, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: serve.serve(ARCH, True, 2, 4, 2),
               lambda: serve.serve_continuous(ARCH, True, 2, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--continuous", "--batch", "2",
                "--prompt-lens", "3,5,4", "--gen", "2", "--device", "cpu"])
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "4", "--gen", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous serve: 3 requests over 2 slots" in out
    assert out.count("generated token block:") == 2
