"""The port's tuning runtime (``repro_torch.core``: ``telemetry``,
``options``, ``resilience``, ``measure``, ``calibrate`` and the measured
half of ``dse``) against the JAX package's on the CPU, on seeded inputs
at small sizes.

Held equal: the histogram edges, span names and nesting; resolved
options for the same environment; the failure taxonomy, the fault
schedule, the crash-safe stores and the tolerances; ``synth_inputs``
bitwise; ``spearman``; the calibration fit bit for bit (the port priced
with ``cost.TPU``, the reference's constants); the tuning-cache keys;
the measured plans and rank tables when both timing DBs hold the same
measurements; the degradation under injected faults, event by event.
Also: a second exploration is a cache hit that lowers nothing, a
recalibration invalidates tuned plans, a planted wrong candidate is
refused by certification and never cached, a plan the reference cached
is a miss for the port, sticky CUDA errors propagate, and serving emits
the reference's spans with its certification under ``call_guarded``.

Named differences: the port's resolved ``vmem_budget`` default is None
(the tier's on-chip bytes; the reference's is its 16 MiB); its device
kinds are ``torch-cpu`` / the card's name (the reference's ``cpu``);
its lowerings are labelled ``cuda`` where the reference's say
``pallas``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import dse as jdse
from repro.core import measure as jmeasure
from repro.core import options as joptions
from repro.core import resilience as jres
from repro.core import telemetry as jtel
from repro.core import pipeline as jpl
from repro.patterns import analytics as jan

from repro_torch.core import calibrate, codegen_cuda, cost, dse, ir
from repro_torch.core import measure, options, pipeline, resilience
from repro_torch.core import telemetry
from repro_torch.device import StickyCudaError
from repro_torch.kernels import build, ops
from repro_torch.patterns import analytics as an

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU = cost.TPU
FAST = resilience.Policy(timeout_s=0, retries=0)
JFAST = jres.Policy(timeout_s=0, retries=0)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide tuning state starts empty for every test
    (the shared conftest resets the reference's)."""
    telemetry.reset()
    resilience.LOG.reset()
    ops.clear_plan_memo()
    yield
    telemetry.reset()
    resilience.LOG.reset()


def _spans(tel):
    return [(s["name"], s.get("parent")) for s in tel.span_log()]


# ------------------------------------------------------------- telemetry
@pytest.mark.parametrize("args", [(1e-6, 1e2, 4), (1e-3, 10.0, 3),
                                  (0.5, 7.0, 1), (2e-9, 3e-2, 8)])
def test_log_bounds_equal_the_reference(args):
    assert telemetry.log_bounds(*args) == jtel.log_bounds(*args)
    assert telemetry.LATENCY_BOUNDS_S == jtel.LATENCY_BOUNDS_S
    for v in (3e-7, 1e-4, 0.2, 5.0, 1e3):
        telemetry.enable()
        jtel.enable()
        telemetry.observe("h", v)
        jtel.observe("h", v)
    assert telemetry.metrics_snapshot()["histograms"] \
        == jtel.metrics_snapshot()["histograms"]


def test_explore_spans_match_the_reference():
    telemetry.enable()
    jtel.enable()
    dse.explore(an.outerprod()[0], tier=TPU, cache=False)
    jdse.explore(jan.outerprod()[0], cache=False)
    got, want = _spans(telemetry), _spans(jtel)
    assert got == want
    assert ("dse.shortlist", "dse.explore") in got
    top = [s for s in telemetry.span_log() if s["name"] == "dse.explore"]
    jtop = [s for s in jtel.span_log() if s["name"] == "dse.explore"]
    assert top[0]["args"] == jtop[0]["args"]


def test_explore_pipeline_spans_match_the_reference():
    telemetry.enable()
    jtel.enable()
    pipe = an.PIPELINES["gda"](n=512)[0]
    jpipe = jan.PIPELINES["gda"](n=512)[0]
    dse.explore_pipeline(pipe, tier=TPU, cache=False)
    jdse.explore_pipeline(jpipe, cache=False)
    got, want = _spans(telemetry), _spans(jtel)
    assert got == want
    names = {n for n, _ in got}
    assert {"dse.explore_pipeline", "dse.shortlist", "fusion.fuse_dag",
            "memory.plan"} <= names


def test_export_trace_passes_check_trace(tmp_path):
    telemetry.enable()
    dse.explore(an.outerprod()[0], tier=TPU, cache=False)
    resilience.record("time", "lower-unsupported", "k", "quarantined")
    path = telemetry.export_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    assert any(e["name"] == "dse.explore" for e in doc["traceEvents"])
    rc = subprocess.run([sys.executable,
                         os.path.join(ROOT, "benchmarks", "check_trace.py"),
                         path], capture_output=True, text=True)
    assert rc.returncode == 0, rc.stdout + rc.stderr


def test_tracing_off_creates_no_registry_entries():
    telemetry.disable()
    assert telemetry.span("x") is telemetry.NULL_SPAN
    telemetry.observe("serve.prefill_s", 0.1)
    telemetry.put_record("plan", "k", {"a": 1})
    plan = dse.explore(an.outerprod()[0], tier=TPU, cache=False)
    snap = telemetry.metrics_snapshot()
    assert snap["spans"] == 0 and snap["histograms"] == {}
    assert telemetry.get_record("plan", "k") is None
    assert telemetry.get_record("plan", plan.key) is None


# --------------------------------------------------------------- options
ENVS = [
    {},
    {"REPRO_MEASURE": "top_k"},
    {"REPRO_MEASURE": ""},
    {"REPRO_DSE_CACHE": "/x/c.json", "REPRO_TIMING_DB": "/x/t.json"},
    {"REPRO_TIMEOUT_S": "7", "REPRO_RETRIES": "3", "REPRO_CERTIFY": "0"},
    {"REPRO_TRACE": "1", "REPRO_BACKOFF_S": "0.5"},
    {"REPRO_TRACE": "off", "REPRO_BUCKETING": "0"},
]


def _fields(o):
    unset = (options.UNSET, joptions.UNSET)
    d = {f.name: "UNSET" if getattr(o, f.name) in unset
         else getattr(o, f.name) for f in dataclasses.fields(o)}
    if dataclasses.is_dataclass(d["policy"]):
        d["policy"] = dataclasses.asdict(d["policy"])
    # named difference: the port's budget default is the tier's (None)
    d.pop("vmem_budget")
    return d


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_options_resolve_as_the_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _fields(options.Options.from_env()) \
        == _fields(joptions.Options.from_env())
    got = dse._resolve_options(options.Options(top_k=5, warmup=0),
                               top_k=7, repeat=None)
    want = jdse._resolve_options(joptions.Options(top_k=5, warmup=0),
                                 top_k=7, repeat=None)
    assert _fields(got) == _fields(want)
    assert got.top_k == 7 and got.warmup == 0
    assert got.vmem_budget is None
    assert want.vmem_budget == jdse.VMEM_BYTES


def test_bucketing_alone_is_refused(monkeypatch):
    with pytest.raises(NotImplementedError, match="tuning-runtime"):
        options.Options(bucketing=True).resolved()
    p = an.outerprod()[0]
    with pytest.raises(NotImplementedError, match="bucketing"):
        dse.explore(p, tier=TPU, bucketing=True)
    monkeypatch.setenv("REPRO_BUCKETING", "1")
    with pytest.raises(NotImplementedError, match="bucketing"):
        dse.explore(p, tier=TPU)
    monkeypatch.delenv("REPRO_BUCKETING")
    assert dse.MXU == options.MXU == jdse.MXU
    assert (dse.DEPTHS, dse.TOP_K, dse.MAX_POINTS, dse.MEASURE_WARMUP,
            dse.MEASURE_REPEAT) == (jdse.DEPTHS, jdse.TOP_K,
                                    jdse.MAX_POINTS, jdse.MEASURE_WARMUP,
                                    jdse.MEASURE_REPEAT)
    assert dse.MODEL_VERSION == jdse.MODEL_VERSION == 5


# ------------------------------------------------------------ resilience
TABLE = [
    lambda m: m.DeadlineExceeded("slow"),
    lambda m: NotImplementedError("no template"),
    lambda m: ValueError("bad shape"),
    lambda m: TypeError("bad arg"),
    lambda m: KeyError("missing"),
    lambda m: IndexError("oob"),
    lambda m: ZeroDivisionError("div"),
    lambda m: OSError("io blip"),
    lambda m: MemoryError(),
    lambda m: RuntimeError("nvcc failed"),
    lambda m: m.InjectedFault("lower", "candidate 3"),
    lambda m: AttributeError("bug"),
]


@pytest.mark.parametrize("make", TABLE, ids=range(len(TABLE)))
def test_classify_matches_the_reference(make):
    got, want = make(resilience), make(jres)
    assert resilience.classify(got) == jres.classify(want)
    assert isinstance(got, resilience.EXPECTED_ERRORS) \
        == isinstance(want, jres.EXPECTED_ERRORS)


class _Lib:
    @staticmethod
    def error_string(rc):
        return {700: b"an illegal memory access was encountered",
                9: b"invalid configuration argument"}[rc]


def test_sticky_cuda_errors_propagate_and_are_never_quarantined():
    with pytest.raises(StickyCudaError, match="700"):
        build.check(_Lib, 700, "launch")
    with pytest.raises(RuntimeError, match="invalid configuration"):
        build.check(_Lib, 9, "launch")
    assert not isinstance(StickyCudaError("x"), resilience.EXPECTED_ERRORS)
    assert resilience.classify(RuntimeError(
        "launch: CUDA error 9 (invalid configuration argument)")) \
        == "compile-error"

    def sticky():
        build.check(_Lib, 700, "tiled_map launch")

    def via_torch():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    for fn in (sticky, via_torch):
        with pytest.raises(StickyCudaError):
            resilience.call_guarded(fn, stage="time", key="k", policy=FAST)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert resilience.is_sticky(accel.__new__(accel))
    assert resilience.LOG.events() == []


def test_out_of_memory_is_retried_after_emptying_the_cache(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 42

    pol = resilience.Policy(timeout_s=0, retries=1, backoff_s=0.0)
    assert resilience.call_guarded(flaky, stage="time", key="k",
                                   policy=pol) == 42
    assert emptied == [1]
    assert [(e.stage, e.kind, e.action)
            for e in resilience.LOG.events()] == [("time", "transient",
                                                   "retried")]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_schedule_equals_the_reference(seed):
    spec = "lower:0.5,time:0.3,certify:1,store-load:0.1"
    got = resilience.FaultInjector.parse(spec, seed=seed)
    want = jres.FaultInjector.parse(spec, seed=seed)
    assert got.specs == want.specs
    for site in ("lower", "time", "certify", "store-load", "other"):
        for _ in range(60):
            a = b = None
            try:
                got.maybe_fail(site)
            except resilience.InjectedFault as e:
                a = str(e)
            try:
                want.maybe_fail(site)
            except jres.InjectedFault as e:
                b = str(e)
            assert a == b


def _store_outcomes(mod, tmp_path, tag):
    out = {}
    bad = tmp_path / f"{tag}_bad.json"
    bad.write_text('{"__meta__": {"version": 1')
    with pytest.warns(UserWarning, match="quarantined"):
        out["truncated"] = mod.load_store(str(bad))
    out["moved"] = os.path.exists(str(bad) + ".corrupt")
    skew = tmp_path / f"{tag}_skew.json"
    mod.save_store(str(skew), {"a": 1}, version=7)
    out["skew"] = mod.load_store(str(skew))
    out["skew_moved"] = os.path.exists(str(skew) + ".corrupt")
    ok = tmp_path / f"{tag}_ok.json"
    mod.save_store(str(ok), {"a": 1})
    out["merged"] = mod.locked_update(str(ok),
                                      lambda d: d.__setitem__("b", 2))
    sum_bad = tmp_path / f"{tag}_sum.json"
    mod.save_store(str(sum_bad), {"a": 1})
    doc = json.loads(sum_bad.read_text())
    doc["data"]["a"] = 2
    sum_bad.write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="checksum"):
        out["checksum"] = mod.load_store(str(sum_bad))
    out["events"] = [(e.stage, e.kind, e.action)
                     for e in mod.LOG.events()]
    return out


def test_stores_behave_as_the_reference(tmp_path):
    assert _store_outcomes(resilience, tmp_path, "port") \
        == _store_outcomes(jres, tmp_path, "ref")


@pytest.mark.parametrize("name", ["float32", "float64", "bfloat16",
                                  "float16", "int32", "bool", "int8"])
def test_tolerances_equal_the_reference(name):
    assert resilience.tolerances(name) == jres.tolerances(name)
    assert resilience.tolerances(getattr(torch, name)) \
        == jres.tolerances(name)


# --------------------------------------------------------------- measure
def _input_sets():
    sets = [an.SUITE[n]()[0] for n in an.SUITE]
    out = [tuple(ir.inputs_of(p)) for p in sets]
    out += [pipeline.external_inputs(an.PIPELINES[n]()[0])
            for n in an.PIPELINES]
    return out


def test_synth_inputs_are_bitwise_the_references():
    from repro.core import ir as jir
    jsets = [tuple(jir.inputs_of(jan.SUITE[n]()[0])) for n in jan.SUITE]
    jsets += [jpl.external_inputs(jan.PIPELINES[n]()[0])
              for n in jan.PIPELINES]
    for ts, jts in zip(_input_sets(), jsets):
        assert [(t.name, t.shape, t.dtype) for t in ts] \
            == [(t.name, t.shape, t.dtype) for t in jts]
        for seed in (0, 5):
            got = measure.synth_inputs(ts, seed=seed, device="cpu")
            want = jmeasure.synth_inputs(jts, seed=seed)
            assert list(got) == list(want)
            for k in got:
                w = np.asarray(want[k])
                assert got[k].numpy().dtype == w.dtype
                assert np.array_equal(got[k].numpy(), w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    xs = list(rng.randint(0, 5, 9).astype(float))
    ys = list(rng.randn(9))
    assert measure.spearman(xs, ys) == jmeasure.spearman(xs, ys)
    assert measure.spearman([1.0], [2.0]) == jmeasure.spearman([1.0], [2.0])


def test_timing_db_round_trips_per_device(tmp_path):
    path = str(tmp_path / "t.json")
    m = measure.Measurement(1e-3, 1.1e-3, 9e-4, 2e-3, 3, 1, "torch-cpu")
    db = measure.TimingDB(path, device="cpu")
    db.put("k", m)
    back = measure.TimingDB(path, device="cpu").get("k")
    assert back == dataclasses.replace(m, cached=True)
    assert measure.TimingDB.full_key("k", device="cpu") \
        == "torch-cpu|interp=1|k"
    # the reference's DB at the same path never sees the port's entry
    assert jmeasure.TimingDB(path).get("k") is None
    assert measure.device_kind("cpu") == "torch-cpu" != jmeasure.device_kind()


def test_measure_excludes_warmup():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= 2:
            import time
            time.sleep(0.05)

    m = measure.measure(fn, warmup=2, repeat=3, device="cpu")
    assert len(calls) == 5 and m.repeat == 3 and m.warmup == 2
    assert m.max_s < 0.04 and m.device == "torch-cpu" and m.interpret
    with pytest.raises(ValueError):
        measure.measure(fn, repeat=0, device="cpu")


# ------------------------------------------------------------- calibrate
def _samples(seed, n=12):
    rng = np.random.RandomState(seed)
    kinds = ["Map", "MultiFold", "Pipeline"]
    out = []
    for i in range(n):
        b = float(rng.randint(1, 1 << 24))
        steps = int(rng.randint(1, 512))
        meas = b / 5e11 + steps * 3e-6 * (1 + rng.rand())
        out.append((f"w{i % 3}", kinds[i % 3], b, steps, meas, f"k{i}"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fit_is_bit_for_bit_the_references(seed):
    raw = _samples(seed)
    got = calibrate.fit([calibrate.Sample(*r) for r in raw],
                        device="d", model_version=5, tier=TPU)
    want = jcal.fit([jcal.Sample(*r) for r in raw], device="d",
                    model_version=5)
    assert got.to_json() == want.to_json() and got.hash == want.hash
    # the scale-only fallback's floor is the prior tier's bandwidth
    neg = [calibrate.Sample("w", "Map", 1e6, 1, 1e-6, "a"),
           calibrate.Sample("w", "Map", 2e6, 400, 5e-7, "b")]
    jneg = [jcal.Sample("w", "Map", 1e6, 1, 1e-6, "a"),
            jcal.Sample("w", "Map", 2e6, 400, 5e-7, "b")]
    assert calibrate.fit(neg, device="d", model_version=5,
                         tier=TPU).to_json() \
        == jcal.fit(jneg, device="d", model_version=5).to_json()


def test_prior_bandwidth_is_the_measured_devices_tier():
    b = 1e9
    assert calibrate.predicted_seconds("Map", b, tier=TPU) \
        == jcal.predicted_seconds("Map", b)
    assert calibrate.predicted_seconds("Map", b, tier=cost.H100_SXM) \
        == b / 3.35e12
    # on the CPU the prior is the port's target card's datasheet tier
    assert calibrate.prior_tier() == cost.DEFAULT_TIER == cost.H100_SXM


def test_profiles_in_one_file_never_mix(tmp_path, monkeypatch):
    path = str(tmp_path / "calibration.json")
    monkeypatch.setenv("REPRO_CALIB_PROFILE", path)
    raw = _samples(3)
    jcal.observe([jcal.Sample(*r) for r in raw[:6]])
    calibrate.observe([calibrate.Sample(*r) for r in raw[6:]],
                      device="torch-cpu", tier=TPU)
    assert [s.key for s in calibrate.load_samples("torch-cpu")] \
        == sorted(r[5] for r in raw[6:])
    assert sorted(s.key for s in jcal.load_samples()) \
        == sorted(r[5] for r in raw[:6])
    assert calibrate.load_profile("torch-cpu").n_samples == 6
    assert jcal.load_profile().n_samples == 6


# ------------------------------------------------------------------- dse
def _programs():
    out = [(n, jan.SUITE[n]()[0], an.SUITE[n]()[0]) for n in an.SUITE]
    out += [(f"pipe-{n}", jan.PIPELINES[n]()[0], an.PIPELINES[n]()[0])
            for n in an.PIPELINES]
    return out


@pytest.mark.parametrize("name,jp,tp", _programs(),
                         ids=[n for n, _, _ in _programs()])
def test_keys_equal_the_references(name, jp, tp):
    extra = (("depths", 2, 3), ("measure", "top_k", 3))
    kw = dict(vmem_budget=123456, align=128, extra=extra, device="dev",
              profile_hash="ph")
    if name.startswith("pipe-"):
        assert dse.pipeline_key(tp, **kw) == jdse.pipeline_key(jp, **kw)
    else:
        assert dse.pattern_key(tp, **kw) == jdse.pattern_key(jp, **kw)
        sig = (("x", (64,)),)
        assert dse.pattern_key(tp, extra=("timing", sig), device="",
                               profile_hash="") \
            == jdse.pattern_key(jp, extra=("timing", sig), device="",
                                profile_hash="")


def _prefill_db(p, jp, top_k=3):
    """The same Measurement for every shortlisted candidate in both
    packages' timing DBs (the measured order the reverse of the
    analytic one), so the measured choice is noise-free."""
    cands, _, _, _ = dse.shortlist(p, tier=TPU,
                                   vmem_budget=TPU.onchip_bytes)
    top = dse._top_distinct_sizes(cands, top_k)
    db, jdb = measure.TimingDB(device="cpu"), jmeasure.TimingDB()
    for i, c in enumerate(top):
        sig = tuple(sorted((k, tuple(v)) for k, v in c.sizes.items()))
        key = dse.pattern_key(p, vmem_budget=TPU.onchip_bytes,
                              extra=("timing", sig), device="",
                              profile_hash="")
        assert key == jdse.pattern_key(jp, extra=("timing", sig),
                                       device="", profile_hash="")
        med = 1e-3 * (len(top) - i)
        db.put(key, measure.Measurement(med, med, med, med, 3, 1,
                                        "torch-cpu"))
        jdb.put(key, jmeasure.Measurement(med, med, med, med, 3, 1, "cpu"))
    return top


def _ranks(plan, mod):
    rec = mod.explain_dict(plan)["provenance"]
    cert = [{k: v for k, v in c.items() if k != "reason"}
            for c in rec["certification"]]
    return rec["analytic_ranks"], rec["measured_ranks"], cert, rec["pruned"]


MEASURED = [("outerprod", lambda m: m.outerprod()[0]),
            ("sumrows", lambda m: m.sumrows()[0]),
            ("tpchq6", lambda m: m.tpchq6()[0])]


@pytest.mark.parametrize("name,build_p", MEASURED, ids=[n for n, _ in MEASURED])
def test_measured_explore_picks_the_references_plan(name, build_p,
                                                     monkeypatch):
    p, jp = build_p(an), build_p(jan)
    top = _prefill_db(p, jp)
    telemetry.enable()
    jtel.enable()
    got = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                      policy=FAST)
    want = jdse.explore(jp, measure="top_k", policy=JFAST)
    assert got.measured and want.measured
    assert got.sizes == want.sizes == top[-1].sizes
    for f in ("depths", "traffic_words", "vmem_bytes", "modeled_seconds",
              "explored", "pruned", "thinned", "measured_seconds",
              "timed"):
        assert getattr(got, f) == getattr(want, f), f
    assert _ranks(got, dse) == _ranks(want, jdse)
    assert calibrate.load_profile("torch-cpu").to_json() \
        == dict(jcal.load_profile().to_json(), device="torch-cpu")
    assert "source: explored" in dse.explain(got)

    # the second call is a cache hit: nothing lowered, timed or certified
    def boom(*a, **k):
        raise AssertionError("lowered on a cache hit")

    monkeypatch.setattr(codegen_cuda, "lower_for_timing", boom)
    monkeypatch.setattr(resilience, "certify_tile_plan", boom)
    again = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                        policy=FAST)
    assert again.cached and again.sizes == got.sizes
    assert again.key == got.key
    assert dse.explain_dict(again)["source"] == "cache"
    assert telemetry.metrics_snapshot()["counters"]["dse.cache_hits"] == 1


@pytest.mark.parametrize("name", ["tpchq6", "kmeans"])
def test_measured_explore_pipeline_picks_the_references_plan(name):
    pipe = an.PIPELINES[name](n=4096)[0]
    jpipe = jan.PIPELINES[name](n=4096)[0]
    priced = dse._price_whole_pipeline(
        pipe, vmem_budget=TPU.onchip_bytes, tier=TPU,
        counters={"explored": 0, "pruned": 0})
    db, jdb = measure.TimingDB(device="cpu"), jmeasure.TimingDB()
    top = priced[:dse.TOP_K]
    for i, ((b, d), _) in enumerate(top):
        key = dse.pipeline_key(pipe, vmem_budget=TPU.onchip_bytes,
                               extra=("timing", b, d), device="",
                               profile_hash="")
        assert key == jdse.pipeline_key(jpipe, extra=("timing", b, d),
                                        device="", profile_hash="")
        med = 1e-3 * (len(top) - i)
        db.put(key, measure.Measurement(med, med, med, med, 3, 1,
                                        "torch-cpu"))
        jdb.put(key, jmeasure.Measurement(med, med, med, med, 3, 1, "cpu"))
    telemetry.enable()
    jtel.enable()
    got = dse.explore_pipeline(pipe, tier=TPU, device="cpu",
                               measure="top_k", policy=FAST)
    want = jdse.explore_pipeline(jpipe, measure="top_k", policy=JFAST)
    assert got.measured and (got.block, got.depths) == top[-1][0][:1] + (
        (top[-1][0][1],),)
    jd, gd = want.to_json(), got.to_json()
    jd.pop("key")
    gd.pop("key")
    assert gd == jd
    assert _ranks(got, dse) == _ranks(want, jdse)
    again = dse.explore_pipeline(pipe, tier=TPU, device="cpu",
                                 measure="top_k", policy=FAST)
    assert again.cached and again.block == got.block


def test_keyed_folds_certify_where_the_references_oracle_refuses():
    """Named difference: ``synth_inputs`` draws gda's float labels
    standard normal (bitwise as the reference), so some keys fall
    outside the table.  Every CAM kernel drops such a key; the
    reference's oracle clamps it into the table, so its certification
    refuses every gda candidate and ships the analytic plan.  The
    port's oracle drops it as the kernels do, and the measured winner
    certifies."""
    p, jp = an.gda()[0], jan.gda()[0]
    top = _prefill_db(p, jp)
    got = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                      policy=FAST)
    want = jdse.explore(jp, measure="top_k", policy=JFAST)
    assert got.measured and got.sizes == top[-1].sizes
    assert not want.measured
    assert [e.kind for e in jres.LOG.events(stage="certify")] \
        == ["certify-failed"] * len(top)
    assert resilience.LOG.events() == []
    inp = measure.synth_inputs(ir.inputs_of(p), device="cpu")
    assert float(inp["labels"].min()) < 0


def test_recalibration_invalidates_tuned_plans():
    p = an.outerprod()[0]
    _prefill_db(p, jan.outerprod()[0])
    first = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                        policy=FAST)
    assert dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                       policy=FAST).cached
    calibrate.observe([calibrate.Sample("other", "Map", 1e6, 3, 1e-3, "x")],
                      device="torch-cpu", tier=TPU)
    fresh = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                        policy=FAST)
    assert not fresh.cached and fresh.key != first.key


FAULT_PROGRAMS = [("outerprod", lambda m: m.outerprod()[0]),
                  ("filter_reduce", None)]


@pytest.mark.parametrize("name,build_p", FAULT_PROGRAMS,
                         ids=[n for n, _ in FAULT_PROGRAMS])
def test_injected_faults_degrade_as_the_reference(name, build_p, tmp_path,
                                                  monkeypatch):
    if build_p is None:
        p, jp = dse.filter_reduce_program(4096), \
            jdse.filter_reduce_program(4096)
    else:
        p, jp = build_p(an), build_p(jan)
    monkeypatch.setenv("REPRO_FAULTS", "lower:0.5,time:1")
    monkeypatch.setenv("REPRO_FAULTS_SEED", "4")
    got = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                      top_k=2, repeat=1, warmup=0, timing_db=False,
                      cache=str(tmp_path / "port.json"), policy=FAST)
    want = jdse.explore(jp, measure="top_k", top_k=2, repeat=1, warmup=0,
                        timing_db=False, cache=str(tmp_path / "ref.json"),
                        policy=JFAST)
    events = [(e.stage, e.kind, e.action) for e in resilience.LOG.events()]
    assert events == [(e.stage, e.kind, e.action)
                      for e in jres.LOG.events()]
    assert ("explore", "no-measured-winner", "fallback") in events
    assert not got.measured and not want.measured
    assert (got.sizes, got.depths, got.modeled_seconds) \
        == (want.sizes, want.depths, want.modeled_seconds)
    monkeypatch.delenv("REPRO_FAULTS")
    analytic = dse.explore(p, tier=TPU, cache=False)
    assert got.sizes == analytic.sizes
    ok, why = resilience.certify_tile_plan(p, got.sizes, device="cpu")
    assert ok, why
    q = resilience.load_store(str(tmp_path / "port.json"))[
        dse.QUARANTINE_KEY]
    jq = jres.load_store(str(tmp_path / "ref.json"))[jdse.QUARANTINE_KEY]
    assert sorted(v["kind"] for v in q.values()) \
        == sorted(v["kind"] for v in jq.values())


def _drop_first_tile(real, bad_sizes):
    def lower(p, sizes, **kw):
        fn, how = real(p, sizes, **kw)
        if sizes != bad_sizes:
            return fn, how

        def dropped():
            out = fn().clone()
            bm, bn = sizes["outer"]
            out[:bm, :bn] = 0
            return out

        return dropped, how
    return lower


def test_a_planted_wrong_candidate_is_refused_and_never_cached(monkeypatch):
    p = an.outerprod()[0]
    top = _prefill_db(p, jan.outerprod()[0])
    bad = top[-1].sizes            # the measured winner
    monkeypatch.setattr(codegen_cuda, "lower_for_timing",
                        _drop_first_tile(codegen_cuda.lower_for_timing,
                                         bad))
    plan = dse.explore(p, tier=TPU, device="cpu", measure="top_k",
                       policy=FAST)
    assert plan.measured and plan.sizes != bad
    assert plan.sizes == top[-2].sizes           # the next fastest
    refused = resilience.LOG.events(stage="certify", action="quarantined")
    assert [e.kind for e in refused] == ["certify-failed"]
    data = resilience.load_store(dse.default_cache_path())
    certs = [v for k, v in data[dse.QUARANTINE_KEY].items()
             if k.startswith("certify|")]
    assert [v["kind"] for v in certs] == ["certify-failed"]
    for key, doc in data.items():
        if key != dse.QUARANTINE_KEY:
            assert {k: tuple(v) for k, v in doc["sizes"].items()} != bad


def test_a_plan_the_reference_cached_is_a_miss_for_the_port():
    jplan = jdse.explore(jan.outerprod()[0])       # default on-disk cache
    assert not jplan.cached and jdse.explore(jan.outerprod()[0]).cached
    p = an.outerprod()[0]
    plan = dse.explore(p, tier=TPU, device="cpu")
    assert not plan.cached and plan.sizes == jplan.sizes
    assert plan.key != jplan.key
    assert dse.explore(p, tier=TPU, device="cpu").cached
    doc = resilience.load_store(dse.default_cache_path())
    assert jplan.key in doc and plan.key in doc


def test_tuning_arguments_reach_every_entry_point():
    p = an.outerprod()[0]
    _prefill_db(p, jan.outerprod()[0])
    call = codegen_cuda.lower_auto(p, tier=TPU, device="cpu",
                                   measure="top_k", policy=FAST)
    assert call.tile_plan.measured
    inp = an.outerprod()[2]()
    np.testing.assert_array_equal(call(**inp).numpy(),
                                  np.outer(inp["x"], inp["y"]))
    pipe, mk, ref = an.PIPELINES["tpchq6"](n=4096)
    opts = options.Options(measure="top_k", top_k=1, repeat=1, warmup=0,
                           policy=FAST)
    run = pipeline.lower_pipeline(pipe, tier=TPU, device="cpu",
                                  options=opts)
    assert run.pipeline_plan.measured and run.pipeline_plan.timed == 1
    np.testing.assert_allclose(float(run(**mk())), ref(mk()), rtol=2e-3)
    blocks, plan = ops.resolve_plan("filter_reduce", 4096, tier=TPU,
                                    device="cpu", options=opts)
    assert plan.measured
    assert ops.resolve_plan("filter_reduce", 4096, tier=TPU, device="cpu",
                            options=opts)[1] is plan
    assert telemetry.metrics_snapshot()["counters"]["ops.memo_hits"] == 1
    from repro_torch.kernels import filter_reduce
    x = torch.linspace(-1, 1, 4096)
    got = filter_reduce.filter_reduce(x, x, -0.5, 0.5, auto_tile=True,
                                      device="cpu", options=opts,
                                      cache=False)
    want = (x * x)[(x >= -0.5) & (x < 0.5)].sum()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- serving
def test_serving_emits_the_references_spans_and_guards_certification(
        monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    calls = []
    real = resilience.call_guarded

    def spy(fn, *, stage, key, policy=None):
        calls.append((stage, key, policy))
        return real(fn, stage=stage, key=key, policy=policy)

    monkeypatch.setattr(resilience, "call_guarded", spy)
    telemetry.enable()
    jtel.enable()
    pol = resilience.Policy(timeout_s=60, retries=0)
    serve.serve_continuous("granite-3-2b", True, 2, 3, prompt_lens=(4, 6),
                           device="cpu", policy=pol)
    jserve.serve_continuous("granite-3-2b", True, 2, 3, prompt_lens=(4, 6))
    assert [c[0] for c in calls] == ["certify"] and calls[0][2] is pol

    def served(tel):
        return {n for n, _ in _spans(tel)
                if n.startswith(("serve.", "steps.build."))}

    assert served(telemetry) == served(jtel)
    assert {"serve.admit", "serve.decode_step", "serve.evict"} \
        <= served(telemetry)
    hist = set(telemetry.metrics_snapshot()["histograms"])
    assert hist == {k for k in jtel.metrics_snapshot()["histograms"]
                    if k.startswith("serve.")}
