"""The port's SSD scan on the CPU against the JAX package's:
``repro_torch.kernels.ssd_scan`` (its plain version, ``device="cpu"``)
against the Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py`` (float32 2e-4, the reference tests' tolerance),
at chunks the kernels cut into several row tiles, and in bfloat16
(2e-2); each pass of the plain version (scores, chunk states, carry,
output) against ``C Bᵀ`` and the sequential recurrence of
``ref.ssd_scan``; the kernels' cut of a chunk (``layout``);
``ref.ssd_scan`` and ``ops.ssd`` against the JAX ones; and
``select_scan_blocks`` exactly as the reference's (``cache=False``) under
``cost.TPU``, at the TPU's 16 MiB and the H100's 232,448 B, raising
where it raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen_jax as jex
from repro.core import dse as jdse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd

from repro_torch.core import codegen_torch as tex
from repro_torch.core import cost, dse
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import SLAB, TILE, layout, ssd_scan, \
    ssd_scan_plain

H100_BUDGET = cost.H100_SXM.onchip_bytes      # 232,448 B


def _softplus(x):
    return np.log1p(np.exp(x))


def _inputs(b, s, h, dh, n, seed=0):
    """The reference tests' inputs: x, B, C standard normal, dt =
    softplus(randn) * 0.1, A = -softplus(randn) - 0.1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, dh)
    dt = _softplus(rng.randn(b, s, h)) * 0.1
    A = -_softplus(rng.randn(h)) - 0.1
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    return [t.astype(np.float32) for t in (x, dt, A, B, C)]


@pytest.mark.parametrize("b,s,h,dh,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 32, 1, 8, 4, 32),       # single chunk
    (1, 256, 2, 16, 32, 128),   # a chunk of two 64-row tiles
    (2, 96, 3, 24, 12, 48),
])
def test_ssd_scan_matches_jax(b, s, h, dh, n, chunk):
    inp = _inputs(b, s, h, dh, n)
    want = jssd(*inp, chunk=chunk)
    got = ssd_scan(*inp, chunk=chunk, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), jref.ssd_scan(*inp), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_bfloat16_matches_jax():
    x, dt, A, B, C = _inputs(2, 128, 4, 32, 16, seed=1)
    bf = [jnp.asarray(t, jnp.bfloat16) for t in (x, dt, B, C)]
    want = jssd(bf[0], bf[1], A, bf[2], bf[3], chunk=32)
    tb = [torch.as_tensor(t).bfloat16() for t in (x, dt, B, C)]
    got = ssd_scan(tb[0], tb[1], A, tb[2], tb[3], chunk=32, device="cpu")
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("mix", ["bf16 x/B/C, f32 dt/A", "f16 x, f32 rest",
                                 "f32 x, bf16 dt"])
def test_ssd_scan_takes_the_reference_kernels_input_types(mix):
    """The reference's kernel reads every input as float32 and returns
    x's type: bfloat16 x, B and C beside float32 dt and A (the types
    Mamba-2's block passes) give a bfloat16 result within 2e-2."""
    x, dt, A, B, C = _inputs(2, 128, 4, 32, 16, seed=2)
    types = {"bf16 x/B/C, f32 dt/A": ("bfloat16", "float32", "bfloat16"),
             "f16 x, f32 rest": ("float16", "float32", "float32"),
             "f32 x, bf16 dt": ("float32", "bfloat16", "float32")}[mix]
    xt, dtt, bct = types
    want = jssd(jnp.asarray(x, xt), jnp.asarray(dt, dtt), A,
                jnp.asarray(B, bct), jnp.asarray(C, bct), chunk=32)
    got = ssd_scan(torch.as_tensor(x).to(getattr(torch, xt)),
                   torch.as_tensor(dt).to(getattr(torch, dtt)), A,
                   torch.as_tensor(B).to(getattr(torch, bct)),
                   torch.as_tensor(C).to(getattr(torch, bct)), chunk=32,
                   device="cpu")
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{xt}"
    want = np.asarray(want, np.float32)
    tol = 2e-2 if "bfloat16" in types else 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_ssd_scan_auto_tile_matches_jax():
    inp = _inputs(1, 128, 2, 16, 8)
    want = jssd(*inp, auto_tile=True)
    got = ssd_scan(*inp, auto_tile=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [16, 48, 64, 96, 128, 384])
def test_sub_chunks_divide_the_chunk(chunk):
    """The kernels compute a chunk whole: its row tiles (TILE rows) and K
    slabs (SLAB steps) cover it exactly, a block's shared bytes fit the
    H100's opt-in budget, and the plain version at that chunk agrees with
    the one at chunk 16."""
    lay = layout(chunk)
    for parts, step in ((lay.row_tiles, TILE), (lay.slabs, SLAB)):
        assert [first for first, _ in parts] == list(range(0, chunk, step))
        assert all(0 < rows <= step for _, rows in parts)
        assert sum(rows for _, rows in parts) == chunk
    assert lay.smem_bytes == (4 * TILE * (SLAB + 4) + 2 * SLAB * TILE
                              + 3 * chunk) * 4 <= H100_BUDGET
    inp = [torch.as_tensor(t) for t in _inputs(1, 384, 2, 8, 8, seed=2)]
    torch.testing.assert_close(ssd_scan_plain(*inp, chunk=chunk),
                               ssd_scan_plain(*inp, chunk=16),
                               rtol=2e-4, atol=2e-4)


def test_layout_outgrows_the_card_at_long_chunks():
    """A block holds cum, dt and w of its chunk: at 16,384 steps the
    kernels need more shared memory than the H100 gives a block (the
    wrapper raises there on the card)."""
    assert layout(14_000).smem_bytes <= H100_BUDGET < layout(16_384).smem_bytes


def _recurrence(x, dt, A, B, C):
    """``ref.ssd_scan``'s sequential recurrence in float64 numpy: y
    (b, s, h, dh) and the state after each step (b, s, h, n, dh)."""
    x, dt, A, B, C = (np.asarray(t, np.float64) for t in (x, dt, A, B, C))
    b, s, h, dh = x.shape
    state = np.zeros((b, h, B.shape[-1], dh))
    ys, states = [], []
    for t in range(s):
        dtt = dt[:, t][:, :, None, None]
        state = state * np.exp(A[:, None, None] * dtt) \
            + dtt * B[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(np.einsum("bn,bhnd->bhd", C[:, t], state))
        states.append(state)
    return np.stack(ys, 1), np.stack(states, 1)


def test_recurrence_is_the_reference():
    inp = _inputs(2, 48, 3, 8, 5, seed=6)
    y, _ = _recurrence(*inp)
    np.testing.assert_allclose(y, jref.ssd_scan(*inp), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,h,dh,n,chunk", [(2, 64, 3, 8, 5, 16),
                                              (1, 96, 2, 16, 12, 48)])
def test_plain_scores_are_c_bt_once_per_batch_and_chunk(b, s, h, dh, n,
                                                        chunk):
    _, _, _, B, C = _inputs(b, s, h, dh, n, seed=7)
    got = ssd.plain_scores(torch.as_tensor(B), torch.as_tensor(C), chunk)
    assert tuple(got.shape) == (b, s // chunk, chunk, chunk)
    for bi in range(b):
        for c in range(s // chunk):
            rows = slice(c * chunk, (c + 1) * chunk)
            want = jnp.dot(jnp.asarray(C[bi, rows]),
                           jnp.asarray(B[bi, rows]).T)
            np.testing.assert_allclose(got[bi, c].numpy(), want,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,h,dh,n,chunk", [(2, 64, 3, 8, 5, 16),
                                              (1, 96, 2, 16, 12, 48)])
def test_plain_states_and_carry_follow_the_recurrence(b, s, h, dh, n,
                                                      chunk):
    """Chunk c's state is the recurrence run over chunk c from a zero
    state; the carry's h_{c-1} is the full recurrence's state at the end
    of chunk c - 1 (zero for the first chunk)."""
    inp = _inputs(b, s, h, dh, n, seed=8)
    x, dt, A, B, _ = (torch.as_tensor(t) for t in inp)
    S, decay = ssd.plain_states(x, dt, A, B, chunk)
    nc = s // chunk
    assert tuple(S.shape) == (b, h, nc, n, dh)
    assert tuple(decay.shape) == (b, h, nc)
    h_prev = ssd.plain_carry(S, decay)
    _, full = _recurrence(*inp)
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        _, part = _recurrence(*(t[:, rows] if t.ndim > 1 else t
                                for t in inp))
        np.testing.assert_allclose(S[:, :, c].numpy(), part[:, -1],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            decay[:, :, c].numpy(),
            np.exp(inp[2][None] * inp[1][:, rows].sum(1)), rtol=1e-5)
        want = full[:, c * chunk - 1] if c else np.zeros_like(full[:, 0])
        np.testing.assert_allclose(h_prev[:, :, c].numpy(), want,
                                   rtol=2e-4, atol=2e-4)


def test_plain_output_from_the_recurrences_state_is_the_reference():
    inp = _inputs(2, 64, 3, 8, 5, seed=9)
    x, dt, A, B, C = (torch.as_tensor(t) for t in inp)
    y_ref, full = _recurrence(*inp)
    h_prev = np.zeros((2, 3, 4, 5, 8))
    h_prev[:, :, 1:] = full[:, 15:63:16].transpose(0, 2, 1, 3, 4)
    got = ssd.plain_output(x, dt, A, C, ssd.plain_scores(B, C, 16),
                           torch.as_tensor(h_prev, dtype=torch.float32), 16)
    np.testing.assert_allclose(got.numpy(), jref.ssd_scan(*inp), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), y_ref, rtol=2e-4, atol=2e-4)


def test_scores_shared_across_heads_not_batch_rows():
    """Three batch rows, four heads: the scores are one per (batch, chunk)
    and every head reads its own row's; the output matches the Pallas
    kernel, and batch row 1 scored with row 0's C Bᵀ over one chunk
    would not."""
    inp = _inputs(3, 64, 4, 8, 6, seed=10)
    want = np.asarray(jssd(*inp, chunk=16))
    got = ssd_scan(*inp, chunk=16, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    x, dt, A, B, C = (torch.as_tensor(t) for t in inp)
    scores = ssd.plain_scores(B, C, 16)
    scores[1, 2] = scores[0, 2]
    S, decay = ssd.plain_states(x, dt, A, B, 16)
    wrong = ssd.plain_output(x, dt, A, C, scores, ssd.plain_carry(S, decay),
                             16)
    shift = np.abs(wrong.numpy() - want)
    assert shift[1, 32:48].max() > 1e-2 and shift[[0, 2]].max() < 2e-4
    assert shift[1, :32].max() < 2e-4 and shift[1, 48:].max() < 2e-4


@pytest.mark.parametrize("bad", ["chunk", "dtype", "shape"])
def test_ssd_scan_refuses_what_it_cannot_take(bad):
    x, dt, A, B, C = (torch.as_tensor(t) for t in _inputs(1, 64, 2, 8, 4))
    kw = {"chunk": 16, "device": "cpu"}
    if bad == "chunk":
        kw["chunk"] = 24
    elif bad == "dtype":        # any floating types are taken; not ints
        B = B.int()
    else:
        A = A[:1]
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, B, C, **kw)


def test_ref_ssd_scan_matches_jax():
    inp = _inputs(2, 48, 3, 8, 5, seed=3)
    want = jref.ssd_scan(*inp)
    got = ref.ssd_scan(*map(torch.as_tensor, inp))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    hi = ref.ssd_scan(*(torch.as_tensor(t).double() for t in inp))
    assert hi.dtype == torch.float64
    np.testing.assert_allclose(hi.numpy(), want, rtol=2e-4, atol=2e-4)


def test_ops_ssd_both_paths():
    inp = _inputs(1, 64, 2, 16, 8, seed=4)
    want = jops.ssd(*inp, chunk=16)
    got = ops.ssd(*inp, chunk=16, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oracle = ops.ssd(*inp, use_kernel=False, device="cpu")
    np.testing.assert_array_equal(
        oracle.numpy(), ref.ssd_scan(*map(torch.as_tensor, inp)).numpy())
    np.testing.assert_allclose(oracle.numpy(),
                               jops.ssd(*inp, use_pallas=False),
                               rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the DSE plan
def _fields(plan):
    d = plan.to_json()
    d.pop("key")
    return d


# (shape, budget) -> chunk, or None where the reference raises
PLANS = {
    ((4096, 128, 64), None): 512,
    ((4096, 128, 64), H100_BUDGET): None,       # mamba2-370m's state
    ((4096, 64, 64), None): 1024,
    ((4096, 64, 64), H100_BUDGET): 128,         # zamba2-2.7b's state
    ((128, 8, 16), None): 128,
    ((128, 8, 16), H100_BUDGET): 128,
}


@pytest.mark.parametrize("case", sorted(PLANS, key=str), ids=str)
def test_select_scan_blocks_matches_the_reference_exactly(case):
    shape, budget = case
    if PLANS[case] is None:
        with pytest.raises(ValueError, match="no tile candidate fits"):
            jdse.select_scan_blocks(*shape, cache=False, vmem_budget=budget)
        with pytest.raises(ValueError, match="no tile candidate fits"):
            dse.select_scan_blocks(*shape, tier=cost.TPU, vmem_budget=budget)
        return
    jchunk, jplan = jdse.select_scan_blocks(*shape, cache=False,
                                            vmem_budget=budget)
    chunk, plan = dse.select_scan_blocks(*shape, tier=cost.TPU,
                                         vmem_budget=budget)
    assert chunk == jchunk == PLANS[case]
    assert _fields(plan) == _fields(jplan)


@pytest.mark.parametrize("arg", ["cache", "measure", "policy", "options"])
def test_select_scan_blocks_refuses_the_tuning_runtime(arg):
    """The selector takes the tuning runtime's arguments (an analytic
    plan is the same with or without a cache or a policy) and refuses
    only shape-bucketed warm starts."""
    import functools
    call = functools.partial(dse.select_scan_blocks, 128, 8, 16,
                             tier=cost.TPU)
    from repro_torch.core import resilience
    from repro_torch.core.options import Options
    if arg == "options":      # bucketing: the one part still refused
        with pytest.raises(NotImplementedError, match="tuning-runtime"):
            call(options=Options(bucketing=True))
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


def test_scan_proxy_evaluates_as_the_reference():
    rng = np.random.RandomState(5)
    inp = {"x": rng.randn(64, 4), "dt": rng.rand(64), "B": rng.randn(64, 3),
           "C": rng.randn(64, 3)}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    got = tex.execute(dse.scan_program(64, 3, 4), inp, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.execute(
        jdse.scan_program(64, 3, 4), inp)), rtol=2e-3, atol=2e-3)
