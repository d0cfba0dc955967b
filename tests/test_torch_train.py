"""The port's training path on the CPU against the JAX package's:
``layers.softmax_xent``, ``model.loss`` and its gradients for every
architecture, ``optim.adamw``, ``launch.steps`` (input specs, the train
step with microbatches and remat, the prefill step), the ``TokenPipeline``
(bit for bit), checkpoints (each package restoring the other's), the
fault-tolerance policies and ``launch.train`` restarting from a
checkpoint.

The reference's weights are carried across by ``convert.params_from_
numpy`` (the weights that start at zero get seeded noise, in both
packages).  Tolerances: float32 rtol 2e-3 with an atol of 2e-3 x the
largest reference value (a gradient leaf's, the updated parameters'),
bfloat16 2e-2 x max; the pipeline, the checkpoint files and the
restored state are exact.
"""
import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.runtime import fault_tolerance as jft

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import steps
from repro_torch.models import convert, layers, model
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft

ALL = sorted(ARCHS)
TOL = {"bfloat16": 2e-2, "float32": 2e-3}
BATCH, SEQ = 2, 16


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    """rtol TOL, atol TOL x max|want|."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * max(np.abs(want).max(),
                                                     1e-30))


def _params(arch, dtype="float32", seed=0, **over):
    jcfg = jget_config(arch, smoke=True).with_(dtype=dtype, **over)
    cfg = get_config(arch, smoke=True).with_(dtype=dtype, **over)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    for name, (shape, kind) in sorted(jmodel.param_shapes(jcfg).items()):
        if kind == "zeros":
            noise = rng.randn(*shape) * 0.1
            jp[name] = jnp.asarray(noise - 0.5 if name == "m_A_log"
                                   else noise, jp[name].dtype)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   cfg, "cpu")
    return jcfg, cfg, jp, tp


def _batch(cfg, seed=1, rows=BATCH):
    """A reference-style batch (the smoke tests' shapes): tokens, labels
    shifted by the pipeline's rule, the VLM's prefix rows."""
    rng = np.random.RandomState(seed)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.randint(0, cfg.vocab, (rows, SEQ) + ncb).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.randn(
            rows, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_jax(dtype, z_loss):
    """float32 logsumexp, the gold logit, the z-loss on lse^2; codebook
    logits (B, S, n_cb, V) with labels (B, S, n_cb)."""
    rng = np.random.RandomState(0)
    for shape in ((3, 7, 50), (2, 5, 4, 33)):
        x = (rng.randn(*shape) * 4).astype(np.float32)
        lab = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
        want = jlayers.softmax_xent(jnp.asarray(x, dtype), jnp.asarray(lab),
                                    z_loss=z_loss)
        got = layers.softmax_xent(torch.as_tensor(x).to(getattr(torch,
                                                                dtype)),
                                  torch.as_tensor(lab), z_loss=z_loss)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL)
def test_loss_matches_jax(arch, dtype):
    """``model.loss`` of every architecture: the padded vocab masked,
    the VLM's prefix positions dropped, codebook labels."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    b = _batch(cfg)
    want = jmodel.loss(jp, jcfg, _jb(b))
    got = model.loss(tp, cfg, _tb(b))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=TOL[dtype])


def test_vlm_loss_drops_the_prefix_and_pad_is_masked():
    """Labels are the text's only: a loss that kept the prefix rows would
    index past them; a vocab pad that won would shift the loss."""
    jcfg, cfg, jp, tp = _params("internvl2-1b", vocab_pad=5)
    b = _batch(cfg)
    got = model.loss(tp, cfg, _tb(b))
    np.testing.assert_allclose(float(got),
                               float(jmodel.loss(jp, jcfg, _jb(b))),
                               rtol=2e-3)
    logits = model.forward(tp, cfg, _tb(b))[:, cfg.frontend_tokens:]
    masked = model.mask_vocab_pad(logits, cfg)
    assert float(masked[..., cfg.vocab:].max()) == float(
        torch.tensor(-1e30))
    np.testing.assert_allclose(
        float(layers.softmax_xent(masked, torch.as_tensor(b["labels"]))),
        float(got), rtol=1e-6)


@pytest.mark.parametrize("arch", ALL)
def test_gradients_match_jax_grad(arch):
    """``torch.autograd`` of ``model.loss`` against ``jax.value_and_grad``
    of the reference's, every parameter (the port's counterpart of the
    reference's train-step smoke test): rtol 2e-3 and an atol of 2e-3 x
    the leaf's largest gradient or, where larger, the reference's own
    float32 sensitivity there -- the largest change of its gradient when
    the weights move by a relative 1e-6 (four seeded perturbations).  The
    recurrent families need it: at these weights the reference's own
    Zamba-2 gradient moves by up to 1.6% of its largest value under such
    a perturbation (Mamba-2's by 0.3%, granite's by 7e-6), so float32
    rounding in another order moves it as much."""
    jcfg, cfg, jp, tp = _params(arch)
    b = _batch(cfg)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jcfg, _jb(b))))
    jl, jg = grad_fn(jp)
    moved = {k: 0.0 for k in jg}
    for seed in range(4):
        rng = np.random.RandomState(seed)
        _, jg2 = grad_fn({k: v * (1 + 1e-6 * jnp.asarray(
            rng.randn(*v.shape), v.dtype)) for k, v in jp.items()})
        for k in jg:
            moved[k] = max(moved[k], float(np.abs(_np(jg[k])
                                                  - _np(jg2[k])).max()))
    names = sorted(tp)
    for n in names:
        tp[n].requires_grad_(True)
    loss = model.loss(tp, cfg, _tb(b))
    grads = torch.autograd.grad(loss, [tp[n] for n in names],
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-3)
    assert set(names) == set(jg)
    for n, g in zip(names, grads):
        assert g.shape == tp[n].shape and bool(torch.isfinite(g).all())
        want = _np(jg[n])
        atol = max(2e-3 * np.abs(want).max(), moved[n])
        np.testing.assert_allclose(_np(g), want, rtol=2e-3, atol=atol)


@pytest.mark.parametrize("arch", ["granite-3-2b", "llama4-maverick-400b-a17b",
                                  "zamba2-2.7b", "mamba2-370m"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each super-block (two layers for
    Llama-4's, a Mamba group and the shared block for Zamba-2's) in the
    backward: the same loss and gradients, bit for bit."""
    _, cfg, _, tp = _params(arch)
    b = _tb(_batch(cfg))
    out = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        for t in tp.values():
            t.requires_grad_(True)
        loss = model.loss(tp, c, b)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(tp.values()), allow_unused=True,
            materialize_grads=True)))
    assert torch.equal(out[0][0], out[1][0])
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)


# ----------------------------------------------------------------- AdamW
def _toy(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_for_several_steps(dtype, compress):
    """Five updates on seeded gradients (large enough that the clip
    acts): parameters, moments, residual and step count against the
    reference's; the warm-up's off-by-one and the bias corrections at the
    incremented step are the reference's."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                            compress_grads=compress)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                              compress_grads=compress)
    host = _toy()
    jp = {k: jnp.asarray(v, dtype) for k, v in host.items()}
    tp = {k: torch.as_tensor(v).to(getattr(torch, dtype))
          for k, v in host.items()}
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, cfg)
    assert ts.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in ts.m.values())
    assert (ts.ef is None) == (not compress)
    for i in range(5):
        g = {k: v * (3.0 if i % 2 else 0.2) for k, v in _toy(10 + i).items()}
        jp, js = jadamw.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp, jcfg)
        tp, ts = adamw.update({k: torch.as_tensor(v) for k, v in g.items()},
                              ts, tp, cfg)
        assert int(ts.step) == int(js.step) == i + 1
        for k in host:
            assert tp[k].dtype == getattr(torch, dtype)
            _close(tp[k], jp[k], dtype)
            _close(ts.m[k], js.m[k])
            _close(ts.v[k], js.v[k])
            if compress:
                _close(ts.ef[k], js.ef[k])


def test_schedule_matches_jax():
    cfg = adamw.AdamWConfig(warmup_steps=10, total_steps=100)
    jcfg = jadamw.AdamWConfig(warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(adamw.schedule(step, cfg),
                                   float(jadamw.schedule(step, jcfg)),
                                   rtol=1e-6)


def test_adamw_reduces_loss():
    """The reference's optimizer test, in the port."""
    cfg = adamw.AdamWConfig(lr=1e-1, warmup_steps=1, total_steps=50,
                            weight_decay=0.0)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "b": torch.zeros((4,), dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    x, y = torch.ones((8, 4)), torch.zeros((8, 4))

    def loss_fn(p):
        return torch.mean((x @ p["w"].float() + p["b"].float() - y) ** 2)

    l0 = float(loss_fn(params))
    for _ in range(20):
        for t in params.values():
            t.requires_grad_(True)
        g = torch.autograd.grad(loss_fn(params), list(params.values()))
        for t in params.values():
            t.requires_grad_(False)
        params, state = adamw.update(dict(zip(params, g)), state, params,
                                     cfg)
    assert float(loss_fn(params)) < l0 * 0.5


def test_grad_compression_error_feedback_and_bounds():
    """The residual keeps the cumulative int8 update close to the
    uncompressed one; a round trip is within half a step."""
    g = torch.as_tensor(np.random.RandomState(0).randn(256)
                        .astype(np.float32)) * 1e-3
    ef = {"g": torch.zeros(256)}
    total = torch.zeros(256)
    for _ in range(50):
        deq, ef = adamw._compress_with_feedback({"g": g}, ef)
        total = total + deq["g"]
    np.testing.assert_allclose(total / 50, g, atol=float(g.abs().max()) / 100)
    x = torch.as_tensor(np.random.RandomState(1).randn(1024)
                        .astype(np.float32))
    q, s = adamw.quantize_int8(x)
    jq, js_ = jadamw.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float((adamw.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) * 0.5 + 1e-6
    np.testing.assert_allclose(float(s), float(js_), rtol=1e-7)


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ALL)
def test_input_specs_and_decode_extras_match_jax(arch, shape):
    """Shapes and types, no memory (``meta`` tensors)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got, want = steps.input_specs(cfg, SHAPES[shape]), \
        jsteps.input_specs(jcfg, JSHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    if SHAPES[shape].kind != "decode":
        return
    (cache, index), (jcache, jindex) = steps.decode_extras(
        cfg, SHAPES[shape]), jsteps.decode_extras(jcfg, JSHAPES[shape])
    flat = ckpt._leaves(cache)
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(jflat)
    for (_, t), (_, j) in zip(flat, jflat):
        assert t.device.type == "meta" and tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    assert tuple(index.shape) == () and index.dtype == torch.int32
    assert str(jindex.dtype) == "int32"


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-1b",
                                  "musicgen-medium"])
def test_prefill_step_returns_the_last_positions_logits(arch):
    jcfg, cfg, jp, tp = _params(arch)
    b = _batch(cfg)
    b.pop("labels")
    want = jsteps.make_prefill_step(jcfg)(jp, _jb(b))
    got = steps.make_prefill_step(cfg)(tp, _tb(b))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, remat):
    """The whole step: loss, updated parameters and optimizer state
    against the reference's ``make_train_step`` at the same
    microbatches; two steps, so the second sees updated moments."""
    jcfg, cfg, jp, tp = _params("granite-3-2b", remat=remat)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, microbatches))
    step = steps.make_train_step(cfg, opt, microbatches)
    js, ts = jadamw.init(jp, jopt), adamw.init(tp, opt)
    for i in range(2):
        b = _batch(cfg, seed=20 + i, rows=4)
        jl, jp, js = jstep(jp, js, _jb(b))
        tl, tp, ts = step(tp, ts, b)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
        for k in tp:
            assert not tp[k].requires_grad
            _close(tp[k], jp[k])
            _close(ts.m[k], js.m[k])


def test_microbatches_average_the_whole_batch_step():
    """Two microbatches of one batch give the one-shot step's loss and
    update (float32 sums in another order)."""
    _, cfg, _, tp = _params("qwen2-72b")
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    b = _batch(cfg, rows=4)
    one = {k: v.clone() for k, v in tp.items()}
    l1, one, _ = steps.make_train_step(cfg, opt, 1)(
        one, adamw.init(one, opt), b)
    l2, tp, _ = steps.make_train_step(cfg, opt, 2)(
        tp, adamw.init(tp, opt), b)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for k in tp:
        _close(tp[k], one[k])
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, opt, 3)(tp, adamw.init(tp, opt), b)


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_pipeline_batches_equal_the_references_bit_for_bit(n_codebooks):
    kw = dict(vocab=1000, global_batch=8, seq_len=16, seed=3,
              n_codebooks=n_codebooks)
    p, jp = TokenPipeline(**kw), JTokenPipeline(**kw)
    for _ in range(3):
        got, want = p.next_batch(), jp.next_batch()
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert p.state_dict() == jp.state_dict()


def test_pipeline_shards_partition_the_global_batch():
    p = TokenPipeline(vocab=100, global_batch=8, seq_len=16, seed=3)
    full = p.batch_slice(0, 0, 8)["tokens"]
    parts = [TokenPipeline(vocab=100, global_batch=8, seq_len=16, seed=3)
             .next_batch(rank=r, world=4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), full)
    np.testing.assert_array_equal(
        JTokenPipeline(vocab=100, global_batch=8, seq_len=16, seed=3)
        .next_batch(rank=2, world=4)["tokens"], parts[2])
    with pytest.raises(ValueError, match="split"):
        p.next_batch(world=3)


def test_pipeline_restart_resumes_the_stream():
    p = TokenPipeline(vocab=50, global_batch=4, seq_len=8, seed=9)
    p.next_batch()
    state = p.state_dict()
    want = p.next_batch()
    p2 = TokenPipeline(vocab=50, global_batch=4, seq_len=8, seed=0)
    p2.load_state_dict(state)
    np.testing.assert_array_equal(want["tokens"], p2.next_batch()["tokens"])


# ----------------------------------------------------------- checkpoint
def _tree():
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": torch.linspace(-3, 3, 4).to(torch.bfloat16)}
    return (params, adamw.init(params, adamw.AdamWConfig()),
            {"step": 7, "seed": 3})


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    tree[1].m["a"].fill_(0.25)
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, _tree())
    for (k, a), (k2, b) in zip(ckpt._leaves(tree), ckpt._leaves(out)):
        assert k == k2
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b and type(a) is type(b)
    names = sorted(os.listdir(tmp_path / "step-7"))
    assert names == ["manifest.json", "shards.npz"]


def test_checkpoint_torn_write_skipped(tmp_path):
    tree = {"a": torch.ones(2)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    with open(tmp_path / "step-2" / "manifest.json", "w") as f:
        f.write("{broken")
    assert ckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(IOError, match="torn"):
        ckpt.restore(str(tmp_path), 2, tree)


def test_async_checkpointer(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.zeros(3)
    for s in (5, 10):
        x.fill_(s)
        w.save_async(s, {"x": x})     # the host copy is taken now
    x.fill_(-1)
    w.close()
    assert ckpt.latest_step(str(tmp_path)) == 10
    for s in (5, 10):
        out = ckpt.restore(str(tmp_path), s, {"x": torch.zeros(3)})
        np.testing.assert_array_equal(out["x"].numpy(), np.full(3, s))


def test_checkpoints_restore_across_the_packages(tmp_path):
    """Same key paths, bfloat16 as its bit pattern: the port reads the
    reference's checkpoint of (params, AdamW state, data state) and the
    reference reads the port's, every value exact."""
    tp, ts, data = _tree()
    ts.step.fill_(4)
    ts.v["nested"].fill_(0.5)
    jp = {"a": jnp.asarray(tp["a"].numpy()),
          "nested": jnp.asarray(tp["nested"].float().numpy(), jnp.bfloat16)}
    js = jadamw.init(jp, jadamw.AdamWConfig())._replace(
        step=jnp.int32(4),
        v={"a": jnp.zeros((2, 3)), "nested": jnp.full((4,), 0.5)})
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jdir, 3, (jp, js, data))
    ckpt.save(tdir, 3, (tp, ts, data))
    for a, b in (("shards.npz", "shards.npz"),):
        za = np.load(os.path.join(jdir, "step-3", a))
        zb = np.load(os.path.join(tdir, "step-3", b))
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])
    got = ckpt.restore(jdir, 3, _tree())
    assert int(got[1].step) == 4 and got[2] == data
    assert torch.equal(got[0]["nested"], tp["nested"])
    assert torch.equal(got[1].v["nested"], ts.v["nested"])
    want = jckpt.restore(tdir, 3, (jp, jadamw.init(jp, jadamw.AdamWConfig()),
                                   {"step": 0, "seed": 0}))
    np.testing.assert_array_equal(
        np.asarray(want[0]["nested"], np.float32),
        tp["nested"].float().numpy())
    assert int(want[1].step) == 4 and int(want[2]["seed"]) == 3


# ------------------------------------------------------ fault tolerance
def test_heartbeat_detects_death():
    for mod in (ft, jft):
        mon = mod.HeartbeatMonitor(["n0", "n1", "n2"], timeout_s=10.0)
        now = 1000.0
        for n in ("n0", "n1", "n2"):
            mon.heartbeat(n, now=now)
        mon.heartbeat("n0", now=now + 8)
        mon.heartbeat("n1", now=now + 8)
        assert mon.sweep(now=now + 12) == ["n2"]
        assert sorted(mon.alive()) == ["n0", "n1"]


def test_rescale_preserves_model_parallel():
    assert ft.plan_rescale(240, model_parallel=16) \
        == ft.RescalePlan(data=15, model=16, dropped=0)
    plan = ft.plan_rescale(12, model_parallel=16)
    assert plan.model == 8 and plan.data == 1
    for n in (1, 7, 100, 255):
        got, want = ft.plan_rescale(n), jft.plan_rescale(n)
        assert (got.data, got.model, got.dropped) == \
            (want.data, want.model, want.dropped)


def test_straggler_evicted_after_patience():
    from repro_torch.core import telemetry
    pol = ft.StragglerPolicy(threshold=1.5, patience=3)
    evicted = []
    for _ in range(5):
        durations = {f"r{i}": 1.0 for i in range(7)}
        durations["r7"] = 3.0
        evicted = pol.record_step(durations)
    assert evicted == ["r7"]
    assert any(e["kind"] == "straggler-evict" and e["rank"] == "r7"
               for e in telemetry.events("recovery"))


def test_straggler_transient_blip_not_evicted():
    pol = ft.StragglerPolicy(threshold=1.5, patience=3)
    for step in range(6):
        durations = {f"r{i}": 1.0 for i in range(8)}
        if step == 2:
            durations["r3"] = 4.0
        assert pol.record_step(durations) == []


# ------------------------------------------------ end-to-end restart drill
def test_train_restart_from_checkpoint(tmp_path):
    """Train 10 steps with checkpoints, 'crash', restart from the
    directory: the run continues from step 10 with the stream rewound
    (finite losses); on the CPU the restarted run's steps equal an
    uninterrupted run's bit for bit."""
    from repro_torch.launch.train import train

    d = str(tmp_path / "a")
    losses1, _ = train("granite-3-2b", smoke=True, n_steps=10, batch=2,
                       seq=32, ckpt_dir=d, ckpt_every=5, log_every=100,
                       device="cpu")
    assert ckpt.latest_step(d) == 10 and len(losses1) == 10
    losses2, _ = train("granite-3-2b", smoke=True, n_steps=14, batch=2,
                       seq=32, ckpt_dir=d, ckpt_every=5, log_every=100,
                       device="cpu")
    assert len(losses2) == 4 and all(np.isfinite(losses2))

    # exact: a 14-step run whose step-10 checkpoint is lost resumes from
    # step 5 and repeats the uninterrupted run's steps 6..14
    e = str(tmp_path / "b")
    whole, pw = train("granite-3-2b", smoke=True, n_steps=14, batch=2,
                      seq=32, ckpt_dir=e, ckpt_every=5, log_every=100,
                      device="cpu")
    import shutil
    shutil.rmtree(os.path.join(e, "step-10"))
    assert ckpt.latest_step(e) == 5
    stats = {}
    resumed, pr = train("granite-3-2b", smoke=True, n_steps=14, batch=2,
                        seq=32, ckpt_dir=e, ckpt_every=100, log_every=100,
                        device="cpu", stats_out=stats)
    assert stats["start"] == 5 and resumed == whole[5:]
    for k in pw:
        assert torch.equal(pr[k], pw[k])


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_train_runs_the_multimodal_families(arch):
    """The VLM trains on zero prefix rows, the audio model on codebook
    frames; losses finite and falling from the first step's."""
    from repro_torch.launch.train import train

    losses, _ = train(arch, smoke=True, n_steps=3, batch=2, seq=16,
                      ckpt_dir=None, log_every=100, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_train_cli_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import train as train_mod

    monkeypatch.setattr("sys.argv", ["train", "--arch", "granite-3-2b",
                                     "--smoke", "--steps", "2",
                                     "--device", "cpu"])
    train_mod.main()
    assert "final loss" in capsys.readouterr().out


def test_training_modules_import_neither_jax_nor_ml_dtypes():
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for sub in ("optim", "data", "checkpoint", "runtime", "launch"):
        for path in sorted((root / sub).glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                mods = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    and node.level == 0 else []
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "ml_dtypes",
                                                   "repro"), (path, m)


@pytest.mark.parametrize("arch", ["granite-3-2b", "musicgen-medium",
                                  "internvl2-1b"])
def test_float32_step_holds_to_the_ports_float64_step(arch):
    """The card's training check on the CPU: the port's own code runs the
    step in float64 (its statistics accumulate in the inputs' type), and
    the float32 step's loss and gradients lie within 2e-3 of it; the
    AdamW update on the same gradients within 1e-5 in norm (rounding the
    parameters to float32 is most of it); labels left unshifted move the
    gradients far past that."""
    _, cfg, _, tp = _params(arch, remat=True)
    cfg64 = cfg.with_(dtype="float64")
    p64 = {k: v.double() for k, v in tp.items()}
    b = _tb(_batch(cfg))
    l64, g64 = steps.value_and_grad(p64, cfg64, b)
    l32, g32 = steps.value_and_grad(tp, cfg, b)
    assert l64.dtype == torch.float64 and g64["embed"].dtype == torch.float64
    np.testing.assert_allclose(float(l32), float(l64), rtol=2e-3)
    for k in g64:
        w = g64[k].numpy()
        np.testing.assert_allclose(g32[k].double().numpy(), w, rtol=2e-3,
                                   atol=2e-3 * np.sqrt((w ** 2).mean()))
    _, bad = steps.value_and_grad(tp, cfg, dict(b, labels=b["tokens"]))
    assert max(float((bad[k].double() - g64[k]).abs().max()
                     / g64[k].abs().max().clamp_min(1e-30))
               for k in g64) > 0.1
    opt = adamw.AdamWConfig(total_steps=6, warmup_steps=1)
    q32 = {k: v.clone() for k, v in tp.items()}
    q64 = {k: v.clone() for k, v in p64.items()}
    adamw.update(g32, adamw.init(q32, opt), q32, opt)
    s64 = adamw.tree_map(lambda t: t.double() if t.is_floating_point()
                         else t, adamw.init(q64, opt))
    adamw.update({k: g.double() for k, g in g32.items()}, s64, q64, opt)
    d32 = torch.cat([(q32[k].double() - p64[k]).reshape(-1) for k in q32])
    d64 = torch.cat([(q64[k] - p64[k]).reshape(-1) for k in q64])
    assert float((d32 - d64).norm() / d64.norm()) < 1e-5
