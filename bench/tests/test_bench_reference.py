"""The plain reference agrees with the program lowered by the port (its
CPU path) at small sizes and with the query as SQL states it; the
comparison passes a sound run and fails the control (the reference in
bfloat16 in the program's place) and each planted fault the cell can
have (``bench/faults.py``)."""
import numpy as np
import pytest

from bench import faults, harness
from bench.data import lineitem
from bench.tests.common import cpu_run, workload_files

from repro_torch.core.pipeline import lower_pipeline

ROWS = 12800


def table(config, seed=2 ** 33 + 1):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    return lineitem.make(cfg, ROWS, seed, "cpu")


@pytest.mark.parametrize("program,config", [("tpch_q6", "tpch-q6-sf100"),
                                            ("tpch_q1", "tpch-q1-sf100")])
def test_reference_agrees_with_the_port(program, config):
    cols = table(config)
    pipe = harness.module("programs", program).pipeline(ROWS)
    out = lower_pipeline(pipe, device="cpu", cache=False)(**cols)
    ref = harness.module("reference", program)
    got = np.asarray(out, np.float64).reshape(-1)
    numbers = ref.errors(got, ref.answer(cols))
    assert max(numbers.values()) < 1e-6


def test_q6_reference_is_the_query():
    c = {k: v.numpy().astype(np.float64) for k, v in
         table("tpch-q6-sf100").items()}
    # SQL's constants; the float32 columns hold 0.05 and 0.07 as float32
    keep = (c["shipdate"] >= 731) & (c["shipdate"] < 1096) & \
        (c["discount"] >= np.float32(0.05)) & \
        (c["discount"] <= np.float32(0.07)) & (c["quantity"] < 24)
    want = (c["extendedprice"] * c["discount"])[keep].sum()
    ref = harness.module("reference", "tpch_q6")
    assert ref.answer(table("tpch-q6-sf100"))[0] == pytest.approx(want,
                                                                 rel=1e-12)
    assert 0.005 < keep.mean() < 0.04        # about 1.8% of the rows


def test_q1_reference_is_the_query():
    cols = table("tpch-q1-sf100")
    c = {k: v.numpy().astype(np.float64) for k, v in cols.items()}
    ref = harness.module("reference", "tpch_q1")
    got = ref.answer(cols).reshape(6, 6)
    keep = c["shipdate"] <= 2436
    filled = []
    for f, flag in enumerate(lineitem.FLAGS):
        for s, status in enumerate(lineitem.STATUS):
            rows = keep & (c["returnflag"] == f) & (c["linestatus"] == s)
            pr, dc = c["extendedprice"][rows], c["discount"][rows]
            want = [c["quantity"][rows].sum(), pr.sum(),
                    (pr * (1 - dc)).sum(),
                    (pr * (1 - dc) * (1 + c["tax"][rows])).sum(),
                    dc.sum(), rows.sum()]
            assert got[2 * f + s] == pytest.approx(want, rel=1e-12)
            if rows.any():
                filled.append(flag + status)
    assert filled == ["AF", "NF", "NO", "RF"]    # Q1's four groups


def test_errors_catch_a_filled_empty_group():
    ref = harness.module("reference", "tpch_q1")
    want = np.zeros(36)
    want[[0, 5]] = [10.0, 2.0]
    got = want.copy()
    assert ref.errors(got, want) == {"sums_err": 0.0, "counts_err": 0.0}
    got[6] = 1e-3                      # a sum in the empty A/O group
    assert ref.errors(got, want)["sums_err"] > 1e6
    got = want.copy()
    got[11] = 1.0                      # a count there
    assert ref.errors(got, want)["counts_err"] == 1.0


@pytest.mark.parametrize("cell", workload_files())
def test_sound_run_is_correct(cell):
    assert cpu_run(cell, seed=2 ** 40 + 3)["correct"] is True


@pytest.mark.parametrize("cell", workload_files())
def test_control_fails(cell):
    out = cpu_run(cell, lower=faults.control)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def fault_cases():
    for cell in workload_files():
        for kind in ("stale", "half", "altered"):
            # a scan asks the same query of the same table every time:
            # it has no state to leave unchanged
            if not (kind == "stale" and cell.endswith(".scan")):
                yield cell, kind


@pytest.mark.parametrize("cell,kind", list(fault_cases()))
def test_planted_fault_fails(cell, kind):
    span = harness.load_cell(cell, False).mix.get("span", 1)
    at = 2 * span + 1          # the warm-up's two requests come first
    out = cpu_run(cell, seconds=0.5, lower=faults.planted(kind, at))
    if kind == "altered":
        assert out["attempted"] * span > at - 2 * span
    assert out["correct"] is False
