"""The k-means cell's parts on the CPU at small sizes: the admissible-
interval check passes the float64 reference's own answer and fails the
TF32 control where points lie near a tie, and the planted faults (with
``test_bench_reference``'s runs of the cell); the yardstick's count at
the source's shape; the readers of its per-layer metrics; the data; the
Lloyd client's restarts, empty clusters and sample of judged steps."""
import numpy as np
import pytest
import torch

from bench import faults, harness, yardstick
from bench.data import mnist_like
from bench.tests.common import ROOT, cpu_run

REF = harness.module("reference", "kmeans_lloyd")
CFG = harness.load_json(ROOT / "bench/configs/kmeans-mnist8m-k256.json")


def exact(x, c):
    """The step in float64: every point to its nearest centroid."""
    xd, cd = x.double(), c.double()
    dist = (xd * xd).sum(1)[:, None] + (cd * cd).sum(1)[None] \
        - 2.0 * xd @ cd.T
    a = dist.argmin(1)
    sums = torch.zeros(c.shape[0], x.shape[1], dtype=torch.float64) \
        .index_add(0, a, xd)
    return {"km_sums": sums.numpy(),
            "km_counts": torch.bincount(a, minlength=c.shape[0]).numpy()}


def points(n, seed=11):
    return mnist_like.make(CFG, n, seed, "cpu")["points"]


def test_reference_passes_its_own_answer():
    x = points(4096)
    c = x[torch.randperm(4096, generator=torch.Generator().manual_seed(0))
          [:256]].clone()
    got = exact(x, c)
    assert REF.errors(got, REF.answer({"points": x, "centroids": c})) == \
        {"sums_err": 0.0, "counts_err": 0.0}


def near_ties(n=8192, pairs=12, seed=3):
    """Centroids in pairs a small step apart: many points lie near a tie
    of a pair, within TF32's error and outside float32's."""
    x = points(n, seed)
    g = torch.Generator().manual_seed(seed)
    base = x[torch.randperm(n, generator=g)[:pairs]]
    step = 3e-3 * torch.randn(base.shape, generator=g)
    return x, torch.cat([base, (base + step).clamp(min=0.0)])


def test_tf32_control_fails_near_ties():
    x, c = near_ties()
    want = REF.answer({"points": x, "centroids": c})
    got = {k: v.numpy() for k, v in REF.control(x, c).items()}
    numbers = REF.errors(got, want)
    limits = harness.load_json(
        ROOT / "bench/workloads/kmeans.lloyd.json")["limits"]
    assert any(numbers[k] > limits[k] for k in limits)
    assert REF.errors(exact(x, c), want) == {"sums_err": 0.0,
                                              "counts_err": 0.0}


def test_float32_rounding_alone_passes_near_ties():
    """The same step in float32 (the expansion, summed in order) moves no
    point out of its admissible clusters."""
    x, c = near_ties()
    s = (c * c).sum(1)[None] - 2.0 * (x @ c.T)
    a = s.argmin(1)
    got = {"km_sums": torch.zeros(c.shape[0], x.shape[1]).index_add(
        0, a, x).numpy(),
        "km_counts": torch.bincount(a, minlength=c.shape[0]).numpy()}
    numbers = REF.errors(got, REF.answer({"points": x, "centroids": c}))
    assert numbers["counts_err"] == 0.0 and numbers["sums_err"] < 1e-6


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_faults_fail_the_cell(kind):
    # the warm-up makes calls 0-2; call 4 is the window's second
    out = cpu_run("kmeans.lloyd", seconds=3.0,
                  lower=faults.planted(kind, 4))
    assert out["attempted"] >= 2 and out["correct"] is False


def test_yardstick_at_the_source_shape():
    n, k, d = 8_099_840, 256, 784
    w = yardstick.work(REF.ops, {"points": (n, d), "centroids": (k, d)},
                       {"km_sums": (k, d), "km_counts": (k,)})
    assert w["ops"] == 2 * n * k * d + n * k + n * (d + 1)
    assert w["ops"] == pytest.approx(3.26e12, rel=2e-3)
    assert w["bound_s"] * 1e3 == pytest.approx(48.7, abs=0.1)
    kw = REF.kernel_work(n, k, d)
    assert set(kw) == {"nearest_assign_kernel", "nearest_fold_kernel"}
    assert sum(o for o, _ in kw.values()) == w["ops"]


def record(segment):
    return harness.Record("kmeans.lloyd", True, 1.0, 0.1, 1.0, [], [],
                          segment, None, 0.05, 0, 0)


@pytest.mark.parametrize("name", ["kmeans_step_roofline",
                                  "nearest_assign_kernel_roofline",
                                  "nearest_fold_kernel_roofline",
                                  "kmeans_idle_pct"])
def test_readers(name):
    read = harness.reader(name, ROOT)
    assert read(record(None)) is None
    seg = {"busy_s": 0.45, "window_s": 0.5, "calls": 4,
           "ops": {"nearest_assign_kernel": 0.3, "nearest_fold_kernel": 0.08,
                   "combine_partials": 0.02, "Memcpy DtoD": 0.001}}
    got = read(record(seg))
    if name == "kmeans_idle_pct":
        assert got == pytest.approx(10.0)
    elif name == "kmeans_step_roofline":
        assert got == pytest.approx(4 * 0.05 / 0.4 * 100)
    else:
        kernel = name[:-len("_roofline")]
        ops, nbytes = REF.kernel_work(CFG["rows"], 256, 784)[kernel]
        t = seg["ops"][kernel]
        assert got == pytest.approx(
            4 * yardstick.bound_s(nbytes, ops) / t * 100)
        assert 0 < got <= 100
    # a program without the path: the TPC-H kernels alone
    if name != "kmeans_idle_pct":
        seg["ops"] = {"fused_dag_kernel": 0.4, "combine_partials": 0.01}
        assert read(record(seg)) is None


def test_data_is_mnist_like():
    a, b = points(4096, 5), points(4096, 5)
    assert torch.equal(a, b) and not torch.equal(a, points(4096, 6))
    assert float(a.min()) == 0.0 and float(a.max()) <= 1.0
    lit = (a > 0).double().mean().item()
    assert 0.1 < lit < 0.35           # MNIST lights ~19% of its pixels


def test_lloyd_client_restarts_and_keeps_empty_clusters():
    gen = harness.module("traffic", "lloyd")
    mix = harness.load_json(ROOT / "bench/traffic/lloyd.json")
    cfg = dict(CFG, args={"k": 8, "d": 784})
    x = points(512)
    calls = []

    def call(points, centroids):
        calls.append(centroids.clone())
        sums = torch.zeros(8, 784)
        counts = torch.zeros(8)
        sums[0], counts[0] = points.sum(0), float(points.shape[0])
        return {"km_sums": sums, "km_counts": counts}

    client = gen.Client(mix, cfg, {"points": x}, call,
                        lambda fn, **t: fn(**t), seed=9)
    client.warm_up()
    for _ in range(mix["iterations"] + 1):
        client.request()
    first = calls[3]
    # warm-up and window start from the same seeded draw
    assert torch.equal(calls[0], first)
    # step 2: cluster 0 moved to the mean, the empty ones kept theirs
    assert torch.allclose(calls[4][0], x.mean(0), atol=1e-6)
    assert torch.equal(calls[4][1:], first[1:])
    # step 21 starts a new clustering from other seeded points
    restart = calls[3 + mix["iterations"]]
    assert not torch.equal(restart, calls[4])
    rows = {tuple(r.tolist()) for r in x}
    assert all(tuple(r.tolist()) in rows for r in restart)
    assert len(client.answers) == mix["iterations"] + 1


def test_judge_samples_first_and_last(monkeypatch):
    gen = harness.module("traffic", "lloyd")
    mix = harness.load_json(ROOT / "bench/traffic/lloyd.json")
    client = gen.Client(mix, dict(CFG, args={"k": 4, "d": 784}),
                        {"points": points(64)}, None, None, seed=1)
    client.inputs = [np.zeros((4, 784), np.float32)] * 40
    client.answers = [{"i": i} for i in range(40)]
    seen = []

    class Ref:
        @staticmethod
        def answer(cols):
            return {"ambiguous": 0.0}

        @staticmethod
        def errors(got, want):
            seen.append(got["i"])
            return {"sums_err": 0.0, "counts_err": 0.0}

    monkeypatch.setattr(gen, "JUDGE_SECONDS", 0.0)
    client.judge(Ref, 40, seed=3)
    assert seen[:2] == [0, 39] and len(seen) == gen.SAMPLE
    assert len(set(seen)) == gen.SAMPLE
    seen.clear()
    monkeypatch.setattr(gen, "JUDGE_SECONDS", 1e9)
    client.judge(Ref, 40, seed=3)
    assert sorted(seen) == list(range(40))
