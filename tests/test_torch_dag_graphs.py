"""The fused-DAG call's graph replays (``codegen_cuda.DagGraphs``), on
the CPU: the input signature a graph is kept under, which DAGs and
calls may replay, the bound on the graphs a callable keeps, the
generated source's graph entry points, and that on the CPU nothing of
it runs (the three counters stay at 0, the answers are the plain
version's).  The replays themselves run on the card
(``test_torch_cuda.py``)."""
import importlib.util
import os

import pytest
import torch

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import cost, telemetry
from repro_torch.kernels import build
from repro_torch.patterns import analytics as an

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA = torch.device("cuda")
COUNTERS = ("fused_dag.graph_captures", "fused_dag.graph_replays",
            "fused_dag.eager_calls")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _tpch(name, rows=4096):
    """The benchmark's TPC-H program ``name`` (``bench/programs``) at
    ``rows`` rows, and random columns for it."""
    path = os.path.join(ROOT, "bench", "programs", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_program_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    g = torch.Generator().manual_seed(rows)
    cols = {c: torch.rand(rows, generator=g) for c in mod.COLUMNS}
    cols["shipdate"] = cols["shipdate"] * 2526.0
    if "returnflag" in cols:
        cols["returnflag"] = torch.randint(0, 3, (rows,), generator=g).float()
        cols["linestatus"] = torch.randint(0, 2, (rows,), generator=g).float()
    cols["discount"] = cols["discount"] * 0.1
    cols["quantity"] = torch.ceil(cols["quantity"] * 50.0)
    return mod.pipeline(rows), cols


def _program(name):
    if name.startswith("tpch_"):
        return _tpch(name)
    pipe, make_inputs, _ = an.PIPELINES[name]()
    return pipe, {k: torch.as_tensor(v) for k, v in make_inputs().items()}


def _lowered(name):
    pipe, inputs = _program(name)
    call = cc.lower_fused_pipeline(pipe, device="cpu", tier=cost.TPU,
                                   cache=False)
    return call, inputs


def test_signature_tells_apart_what_a_launch_depends_on():
    big = torch.arange(256, dtype=torch.float32)
    x = big[:64]

    def sig(t, stream=(0, 7)):
        return cc.dag_signature({"x": t, "unused": None}, ("x",), stream)

    key = sig(x)
    assert key == sig(x) and hash(key) == hash(sig(x))
    assert key == sig(big[:64])          # another view of the same words
    assert key[0] == (0, 7)              # the stream comes first
    assert sig(big[4:68]) != key         # another offset
    assert sig(big[:128:2]) != key       # another stride
    assert sig(big[:64].view(8, 8)) != key          # another shape
    assert sig(x.view(torch.int32)) != key          # another dtype
    assert sig(x, stream=(0, 8)) != key             # another stream
    assert sig(x, stream=(1, 7)) != key             # another card's
    assert cc.dag_signature({"x": x.numpy()}, ("x",), (0, 7)) is None
    with pytest.raises(KeyError):
        cc.dag_signature({}, ("x",), (0, 7))


@pytest.mark.parametrize("name, graphable", [
    ("tpch_q6", True), ("tpch_q1", True), ("gda", True), ("kmeans", True),
    ("gda_moments", True), ("normalize", False)])
def test_graphable_by_the_terminals_kinds(name, graphable):
    """Folds and CAM terminals replay; a Map terminal (normalize) writes
    a whole output and keeps the eager path; the CPU never replays."""
    call, _ = _lowered(name)
    spec = call.group_calls[0].kernel.spec
    kinds = {t.kind for t in spec.terminals}
    assert ("map" not in kinds) is graphable
    assert cc.graphable(spec, CUDA) is graphable
    assert not cc.graphable(spec, torch.device("cpu"))


def test_replayable_only_when_staging_kept_the_callers_tensors():
    call, inputs = _lowered("tpch_q6")
    spec = call.group_calls[0].kernel.spec
    telemetry.disable()
    assert cc.replayable(spec, CUDA, inputs, dict(inputs))
    # a view off a 16-byte boundary is copied by the staging
    name = spec.inputs[0][0]
    odd = dict(inputs)
    big = torch.empty(inputs[name].numel() + 1)
    big[1:] = inputs[name]
    odd[name] = big[1:]
    assert odd[name].data_ptr() % 16
    staged = {k: build.aligned(v) for k, v in odd.items()}
    assert staged[name] is not odd[name]
    assert not cc.replayable(spec, CUDA, odd, staged)
    # device spans time eager launches; host spans alone do not stop it
    telemetry.enable()
    assert not cc.replayable(spec, CUDA, inputs, dict(inputs))
    telemetry.enable(device=False)
    assert cc.replayable(spec, CUDA, inputs, dict(inputs))
    # the CPU, and a DAG with a Map terminal, never
    assert not cc.replayable(spec, torch.device("cpu"), inputs, inputs)
    norm, norm_in = _lowered("normalize")
    assert not cc.replayable(norm.group_calls[0].kernel.spec, CUDA,
                             norm_in, dict(norm_in))


def test_graphs_kept_are_bounded_oldest_first(monkeypatch):
    """At most ``DAG_GRAPHS`` signatures a callable; the oldest goes
    first, and each capture is counted."""
    made = []

    class FakeGraph:
        def __init__(self, kernel, ins, dev, stream):
            made.append((tuple(t.data_ptr() for t in ins), stream))

    monkeypatch.setattr(cc, "DagGraph", FakeGraph)
    monkeypatch.setattr(cc, "DAG_GRAPHS", 3)
    call, inputs = _lowered("tpch_q6")
    graphs = cc.DagGraphs(call.group_calls[0].kernel, CUDA)
    assert graphs.names == tuple(n for n, _ in graphs.kernel.spec.inputs)
    keys = [cc.dag_signature(inputs, graphs.names, (0, s)) for s in range(5)]
    for k in keys:
        graphs.capture(k, inputs)
    assert list(graphs.plans) == keys[2:]
    assert [s for _, s in made] == list(range(5))
    assert telemetry.metrics_snapshot()["counters"][
        "fused_dag.graph_captures"] == 5


@pytest.mark.parametrize("name", ["tpch_q6", "tpch_q1", "gda", "normalize"])
def test_on_the_cpu_nothing_replays(name):
    """The CPU takes the plain version, as before: no graphs, the three
    counters stay at 0, and every call's answer is the plain version's."""
    call, inputs = _lowered(name)
    dag = call.group_calls[0]
    assert dag.graphs is None
    want = cc.fused_dag_plain(dag.kernel.spec, inputs)
    for _ in range(3):
        out = call(**inputs)
        out = out if isinstance(out, dict) else {next(iter(want)): out}
        assert set(out) <= set(want)
        for k, v in out.items():
            assert torch.equal(v, want[k]), k
    counters = telemetry.metrics_snapshot()["counters"]
    assert [counters.get(c, 0) for c in COUNTERS] == [0, 0, 0]


def test_source_captures_the_eager_launches():
    """The graph entry point launches the megakernel through the same
    helper as ``fdag_launch``, and the combine through
    ``fdag::launch_combine`` (``fdag_combine``'s grid and block), so a
    replay runs the eager path's two kernels."""
    call, _ = _lowered("tpch_q1")
    src = call.group_calls[0].kernel.source
    for fn in ("fdag_launch", "fdag_combine", "fdag_graph",
               "fdag_graph_launch", "fdag_graph_free"):
        assert f'extern "C" int {fn}(' in src
    assert src.count("fused_dag_kernel<<<") == 1
    assert src.count("launch_dag(ins, outs, partials, ctas,") == 2
    assert "cudaStreamBeginCapture" in src and "cudaGraphLaunch" in src
    assert "fdag::launch_combine(" in src
