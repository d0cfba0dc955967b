"""The port's shape-bucket layer (``repro_torch.core.buckets``) against
the JAX package's ``core/buckets``, case by case as
``tests/test_buckets.py`` holds the reference: the bucket ladder, family
signatures that ignore extents, the bucket index riding the tuning cache,
a cold shape warm-started with no foreground lowering (its plan the
reference's, under ``cost.TPU``), the background re-tune promoting only a
certified winner, warm plans never persisted, pipeline warm starts, a
warm-started kernel against the exact-shape oracle, and ``resolve_plan``
memoizing exact plans but never warm starts.

Then the hand kernels' own plans on the card's tier (``dse.KernelSpace``)
under bucketing: a cold attention or SSD shape is warm-started onto a
tile the kernel launches at that shape, and its re-tune is certified by
running the kernel's wrapper (its plain version on the CPU) against the
float64 oracle, never by construction.
"""
import numpy as np
import pytest

from repro.core import buckets as jbuckets
from repro.core import dse as jdse
from repro.core.options import Options as JOptions

from repro_torch.core import buckets, cost, dse, measure, resilience
from repro_torch.core import telemetry
from repro_torch.core.dse import TuningCache
from repro_torch.core.options import Options
from repro_torch.kernels import ops

TPU = cost.TPU
H100 = cost.H100_SXM


@pytest.fixture(autouse=True)
def _fresh_bucket_state():
    """The port's process-wide bucket counters, event log, telemetry and
    plan memo start empty; no re-tune outlives its test."""
    buckets.drain(timeout=60.0)
    buckets.reset_stats()
    resilience.LOG.reset()
    telemetry.reset()
    ops.clear_plan_memo()
    yield
    buckets.drain(timeout=60.0)


def _family_kw(tier=TPU):
    return dict(vmem_budget=tier.onchip_bytes, align=dse.MXU, tier=tier,
                device=measure.device_kind())


# ------------------------------------------------------------ bucket ladder
def test_bucket_extent_ladder():
    # {s*2^j, s*3*2^(j-1)}: powers of two plus their 1.5x midpoints
    assert [buckets.bucket_extent(n, sublane=8)
            for n in (1, 8, 9, 24, 25, 100, 128, 129, 200)] \
        == [8, 8, 16, 24, 32, 128, 128, 192, 256]
    assert buckets.bucket_extent(3, sublane=16) == 16
    for s in (1, 8, 16, 32):
        for n in range(1, 5000, 7):
            b = buckets.bucket_extent(n, sublane=s)
            assert b == jbuckets.bucket_extent(n, sublane=s)
            assert b >= n and b % s == 0


def test_tile_family_ignores_extents():
    kw = _family_kw()
    f1 = buckets.tile_family(dse.gemm_program(256, 256, 256), **kw)
    f2 = buckets.tile_family(dse.gemm_program(120, 512, 384), **kw)
    f3 = buckets.tile_family(dse.attention_program(256, 256, 64), **kw)
    assert f1 == f2          # same pattern structure, any shape
    assert f1 != f3          # different pattern structure
    # a tier is part of the family: one device plans for several
    assert f1 != buckets.tile_family(dse.gemm_program(256, 256, 256),
                                     **_family_kw(H100))
    assert buckets.tile_buckets(dse.gemm_program(250, 256, 256),
                                align=dse.MXU) \
        == jbuckets.tile_buckets(jdse.gemm_program(250, 256, 256),
                                 align=jdse.MXU)


# --------------------------------------------------- round-trip + warm start
def _tuned_cache(tmp_path, shape=(256, 256, 256)):
    """A TuningCache holding one tuned gemm donor (bucketing on)."""
    tc = TuningCache(path=str(tmp_path / "bucketed.json"))
    plan = dse.explore(dse.gemm_program(*shape), tier=TPU,
                       options=Options(cache=tc, bucketing=True))
    buckets.drain()
    return tc, plan


def test_bucket_index_round_trips_through_cache(tmp_path):
    tc, plan = _tuned_cache(tmp_path)
    fam = buckets.tile_family(dse.gemm_program(256, 256, 256),
                              **_family_kw())
    entries = tc.bucket_entries(fam)
    assert len(entries) == 1
    (sig, entry), = entries.items()
    assert entry["kind"] == "tile" and sig == "gemm=256x256;gemm_k=256"
    assert dse.TilePlan.from_json(entry["plan"]).sizes == plan.sizes
    # reload from disk: the index rides the persistent document
    tc2 = TuningCache(path=tc.path)
    assert tc2.bucket_entries(fam) == entries


def test_cold_shape_warm_starts_with_zero_foreground_lowering(
        tmp_path, monkeypatch):
    """A cold shape in a tuned bucket is served the donor's re-fitted
    plan immediately: no kernel lowering, no candidate enumeration --
    exactly one analytic pricing of the fitted plan -- and the plan is
    the reference's warm start for the same cold shape."""
    tc, _ = _tuned_cache(tmp_path)
    from repro_torch.core import codegen_cuda

    def _boom(*a, **k):
        raise AssertionError("foreground lowering during warm start")

    monkeypatch.setattr(codegen_cuda, "lower_for_timing", _boom)
    monkeypatch.setattr(measure, "timed", _boom)
    scheduled = []
    monkeypatch.setattr(buckets, "schedule_retune",
                        lambda tag, *a, **k: scheduled.append(tag))
    calls = []
    real_price = dse.price
    monkeypatch.setattr(
        dse, "price",
        lambda *a, **k: calls.append(1) or real_price(*a, **k))

    buckets.reset_stats()
    # 250 is not on the donor grid but buckets to 256
    warm = dse.explore(dse.gemm_program(250, 256, 256), tier=TPU,
                       options=Options(cache=tc, bucketing=True))
    assert warm.warm_start
    assert warm.bucket == "gemm=256x256;gemm_k=256"
    assert len(calls) == 1                  # priced, never enumerated
    assert scheduled and scheduled[0].startswith("tile|")
    assert buckets.stats()["warm_hits"] == 1
    for name, extents in (("gemm", (250, 256)), ("gemm_k", (256,))):
        for t, extent in zip(warm.sizes[name], extents):
            assert extent % t == 0
    # the reference's warm start of the same cold shape
    jtc = jdse.TuningCache(path=str(tmp_path / "ref.json"))
    jdse.explore(jdse.gemm_program(256, 256, 256),
                 options=JOptions(cache=jtc, bucketing=True))
    jbuckets.drain()
    jwarm = jbuckets.warm_start_tile(jdse.gemm_program(250, 256, 256), jtc,
                                     vmem_budget=jdse.VMEM_BYTES,
                                     align=jdse.MXU)
    assert (warm.sizes, warm.depths, warm.bucket, warm.traffic_words,
            warm.vmem_bytes) == (jwarm.sizes, jwarm.depths, jwarm.bucket,
                                 jwarm.traffic_words, jwarm.vmem_bytes)


def test_background_retune_promotes_certified_winner(tmp_path):
    tc, _ = _tuned_cache(tmp_path)
    buckets.reset_stats()
    p = dse.gemm_program(250, 256, 256)
    warm = dse.explore(p, tier=TPU, options=Options(cache=tc,
                                                    bucketing=True))
    assert warm.warm_start
    buckets.drain()
    s = buckets.stats()
    assert s["retunes"] == 1 and s["promotions"] == 1
    assert s["retune_failures"] == 0
    # the promoted exact-shape winner is now a plain cache hit, and the
    # reference's exact plan for the shape
    again = dse.explore(p, tier=TPU, options=Options(cache=tc,
                                                     bucketing=True))
    assert again.cached and not again.warm_start
    assert buckets.stats()["exact_hits"] == 1
    assert buckets.hit_rate() == 1.0
    want = jdse.explore(jdse.gemm_program(250, 256, 256), cache=False)
    assert again.sizes == want.sizes and again.depths == want.depths


def test_uncertified_retune_is_discarded(tmp_path, monkeypatch):
    """A background winner that fails certification is never promoted:
    the cache keeps no entry for the exact shape and the failure is
    counted + recorded, not raised."""
    tc, _ = _tuned_cache(tmp_path)
    monkeypatch.setattr(
        resilience, "certify_tile_plan",
        lambda *a, **k: (False, "forced miscompare (test)"))
    buckets.reset_stats()
    resilience.LOG.reset()
    p = dse.gemm_program(250, 256, 256)
    warm = dse.explore(p, tier=TPU, options=Options(cache=tc,
                                                    bucketing=True))
    assert warm.warm_start
    buckets.drain()
    s = buckets.stats()
    assert s["promotions"] == 0 and s["retune_failures"] == 1
    again = dse.explore(p, tier=TPU, options=Options(cache=tc,
                                                     bucketing=True))
    assert again.warm_start and not again.cached
    assert any(e.stage == "retune" and e.kind == "certify-failed"
               for e in resilience.LOG.events())


def test_retune_failure_is_recorded_not_swallowed(tmp_path, monkeypatch):
    """A re-tune that raises (a build error, say) is counted and recorded
    as a ``retune`` event; ``drain`` returns with nothing in flight."""
    tc, _ = _tuned_cache(tmp_path)
    real = dse.explore

    def failing(p, **kw):
        if kw.get("options") is not None and not kw["options"].bucketing:
            raise RuntimeError("nvcc failed: planted")
        return real(p, **kw)

    monkeypatch.setattr(dse, "explore", failing)
    buckets.reset_stats()
    resilience.LOG.reset()
    warm = real(dse.gemm_program(250, 256, 256), tier=TPU,
                options=Options(cache=tc, bucketing=True))
    assert warm.warm_start
    buckets.drain()
    assert buckets.stats()["retune_failures"] == 1
    assert not buckets._THREADS and not buckets._INFLIGHT
    assert any(e.stage == "retune" and "planted" in e.detail
               for e in resilience.LOG.events())


def test_warm_start_plans_never_persist(tmp_path):
    tc, _ = _tuned_cache(tmp_path)
    warm = dse.explore(dse.gemm_program(250, 256, 256), tier=TPU,
                       options=Options(cache=tc, bucketing=True))
    assert warm.warm_start
    js = warm.to_json()
    assert "warm_start" not in js and "bucket" not in js
    rt = dse.TilePlan.from_json(js)
    assert rt.warm_start is False and rt.bucket == ""
    assert dse.explain_dict(warm)["source"] == "warm_start"
    buckets.drain()


def test_pipeline_bucket_warm_start_round_trip(tmp_path):
    tc = TuningCache(path=str(tmp_path / "pipe.json"))
    opts = Options(cache=tc, bucketing=True)
    donor = dse.explore_pipeline(dse.filter_fold_pipeline(4096), tier=TPU,
                                 options=opts)
    buckets.drain()
    buckets.reset_stats()
    warm = dse.explore_pipeline(dse.filter_fold_pipeline(4000), tier=TPU,
                                options=opts)
    assert warm.warm_start and warm.fused
    assert warm.depths == (donor.depths[0],)
    assert 4000 % warm.block == 0
    jtc = jdse.TuningCache(path=str(tmp_path / "ref.json"))
    jopts = JOptions(cache=jtc, bucketing=True)
    jdse.explore_pipeline(jdse.filter_fold_pipeline(4096), options=jopts)
    jbuckets.drain()
    jwarm = jdse.explore_pipeline(jdse.filter_fold_pipeline(4000),
                                  options=jopts)
    jbuckets.drain()
    assert (warm.block, warm.depths, warm.bucket) == (jwarm.block,
                                                      jwarm.depths,
                                                      jwarm.bucket)
    buckets.drain()
    assert buckets.stats()["promotions"] == 1


# ----------------------------------------------- numerical equivalence
def test_warm_started_kernel_matches_exact_oracle(tmp_path, monkeypatch):
    """The kernel running under a warm-start plan (and its
    padded-to-bucket variant) computes the same numbers as the
    exact-shape oracle (the CPU runs its plain version)."""
    from repro_torch.kernels import matmul as mm

    tc_path = str(tmp_path / "mm.json")
    monkeypatch.setenv("REPRO_DSE_CACHE", tc_path)
    opts = Options(bucketing=True)
    dse.explore(dse.gemm_program(256, 256, 256), tier=H100,
                options=Options(cache=tc_path, bucketing=True))
    buckets.drain()
    ops.clear_plan_memo()

    rng = np.random.RandomState(0)
    x = rng.randn(250, 256).astype(np.float32)
    y = rng.randn(256, 256).astype(np.float32)
    oracle = x @ y
    buckets.reset_stats()
    got = mm.matmul(x, y, auto_tile=True, options=opts, device="cpu")
    assert buckets.stats()["warm_hits"] == 1
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)
    xp = np.zeros((256, 256), np.float32)
    xp[:250] = x
    padded = mm.matmul(xp, y, auto_tile=True, options=opts,
                       device="cpu").numpy()[:250]
    np.testing.assert_allclose(padded, oracle, rtol=2e-5, atol=2e-5)
    buckets.drain()


def test_resolve_plan_memoizes_but_not_warm_starts(tmp_path):
    tc_path = str(tmp_path / "memo.json")
    opts = Options(cache=tc_path, bucketing=True)
    dse.explore(dse.gemm_program(256, 256, 256), tier=TPU, options=opts)
    buckets.drain()
    ops.clear_plan_memo()

    _, p1 = ops.resolve_plan("gemm", 250, 256, 256, tier=TPU, options=opts)
    assert p1.warm_start
    buckets.drain()         # background promotion lands
    _, p2 = ops.resolve_plan("gemm", 250, 256, 256, tier=TPU, options=opts)
    assert not p2.warm_start and p2.cached
    _, p3 = ops.resolve_plan("gemm", 250, 256, 256, tier=TPU, options=opts)
    assert p3 is p2          # steady state memoizes


# ------------------------------------ the hand kernels' plans, bucketed
@pytest.mark.parametrize("cold", [(1, 40, 200, 64), (1, 80, 200, 64),
                                  (8, 20, 50, 128), (1, 1, 300, 80)])
def test_attention_kernel_plan_warm_starts_onto_a_tile_it_launches(
        tmp_path, cold):
    """On the card's tier a cold attention shape in a tuned bucket is
    warm-started onto a tile the kernel takes at that shape (and charged
    that tile's bytes); the re-tune certifies by running the kernel's
    wrapper and promotes the exact plan."""
    from repro_torch.core import codegen_cuda as cc

    group, sq, sk, d = cold
    opts = Options(cache=str(tmp_path / "fa.json"), bucketing=True)
    donor_shape = (sq + 4, sk + 40, d) if sq > 1 else (1, sk + 40, d)
    dse.select_attention_blocks(*donor_shape, group, "bfloat16",
                                tier=H100, options=opts)
    buckets.drain()
    buckets.reset_stats()
    resilience.LOG.reset()
    certified = []
    real = resilience.certify_attention_plan
    resilience.certify_attention_plan = \
        lambda *a, **k: certified.append(a) or real(*a, **k)
    try:
        blocks, warm = dse.select_attention_blocks(
            sq, sk, d, group, "bfloat16", tier=H100, options=opts)
        buckets.drain()
    finally:
        resilience.certify_attention_plan = real
    assert warm.warm_start, buckets.stats()
    which = "wgmma" if d % 8 == 0 else "ffma"
    assert blocks[0] in cc.fa_tiles(which, group * sq)
    assert blocks[1] == cc.FA_BC
    assert warm.vmem_bytes == cc.fa_smem_bytes(which, blocks[0], d)
    assert buckets.stats()["promotions"] == 1, resilience.LOG.events()
    assert certified and certified[0][:5] == (sq, sk, d, group, "bfloat16")
    again_blocks, again = dse.select_attention_blocks(
        sq, sk, d, group, "bfloat16", tier=H100, options=opts)
    assert again.cached and not again.warm_start
    assert again_blocks == dse.select_attention_blocks(
        sq, sk, d, group, "bfloat16", tier=H100, cache=False)[0]


def test_scan_kernel_plan_warm_starts_and_certifies(tmp_path):
    opts = Options(cache=str(tmp_path / "ssd.json"), bucketing=True)
    dse.select_scan_blocks(1024, 16, 8, tier=H100, options=opts)
    buckets.drain()
    buckets.reset_stats()
    chunk, warm = dse.select_scan_blocks(960, 16, 8, tier=H100,
                                         options=opts)
    assert warm.warm_start and 960 % chunk == 0
    from repro_torch.kernels.ssd_scan import layout
    assert warm.vmem_bytes == layout(chunk).smem_bytes
    buckets.drain()
    assert buckets.stats()["promotions"] == 1, resilience.LOG.events()
    assert dse.select_scan_blocks(960, 16, 8, tier=H100,
                                  options=opts)[1].cached


def test_kernel_plan_certification_rejects_a_wrong_kernel(monkeypatch):
    """The kernel plans' certificates compare the wrapper with the
    oracle: a wrong kernel fails them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    assert resilience.certify_attention_plan(
        40, 44, 16, 2, "float32", (64, 64), device="cpu")[0]
    assert resilience.certify_scan_plan(64, 8, 4, 16, device="cpu")[0]
    real_fa, real_ssd = fa.flash_attention, ssd.ssd_scan
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: real_fa(*a, **k) * 1.1)
    monkeypatch.setattr(ssd, "ssd_scan", lambda *a, **k: real_ssd(*a, **k)
                        + 0.05)
    ok, why = resilience.certify_attention_plan(40, 44, 16, 2, "float32",
                                                (64, 64), device="cpu")
    assert not ok and "max_abs_err" in why
    assert not resilience.certify_scan_plan(64, 8, 4, 16, device="cpu")[0]


def test_drain_never_returns_with_work_in_flight():
    """``drain`` joins every re-tune; one still running past its timeout
    raises instead of returning."""
    import threading
    release = threading.Event()
    buckets.schedule_retune(
        "slow", lambda: release.wait(5) and None,
        certify=lambda plan: (True, "ok"), promote=lambda plan: None,
        policy=resilience.Policy(timeout_s=0))
    with pytest.raises(resilience.DeadlineExceeded, match="slow"):
        buckets.drain(timeout=0.2)
    release.set()
    buckets.drain(timeout=10.0)
    assert buckets.stats()["promotions"] == 1


def test_stats_windows_mirror_the_reference():
    before = buckets.snapshot()
    for kind in ("exact_hits", "warm_hits", "misses", "misses"):
        buckets.note(kind)
    d = buckets.delta(before)
    assert buckets.delta_hit_rate(d) == 0.5 == buckets.hit_rate()
    assert telemetry.metrics_snapshot()["counters"].get("bucket.misses") == 2
    jb = jbuckets.snapshot()
    for kind in ("exact_hits", "warm_hits", "misses", "misses"):
        jbuckets.note(kind)
    assert jbuckets.delta_hit_rate(jbuckets.delta(jb)) \
        == buckets.delta_hit_rate(d)
    assert sorted(buckets.stats()) == sorted(jbuckets.stats())


def test_counters_and_dedup_hold_under_contention():
    """More threads than cores, a shortened switch interval: no lost
    counter update, and one re-tune per tag however many threads ask."""
    import os
    import sys
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    release = threading.Event()
    try:
        n = 4 * (os.cpu_count() or 2)

        def count():
            for _ in range(100):
                buckets.note("misses")

        def ask(out):
            out.append(buckets.schedule_retune(
                "one-tag", lambda: release.wait(10) and None,
                certify=lambda plan: (True, "ok"),
                promote=lambda plan: None,
                policy=resilience.Policy(timeout_s=0)))

        started = []
        threads = [threading.Thread(target=count) for _ in range(n)]
        threads += [threading.Thread(target=ask, args=(started,))
                    for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert buckets.stats()["misses"] == 100 * n
        assert sum(t is not None for t in started) == 1
        assert buckets.stats()["retunes"] == 1
    finally:
        release.set()
        sys.setswitchinterval(old)
    buckets.drain(timeout=30.0)
    assert buckets.stats()["promotions"] == 1
