"""The generators repeat exactly for a seed: the traffic's partition
starts and the data, at seeds wider than 32 bits too."""
import itertools

import numpy as np
import pytest
import torch

from bench import harness
from bench.data import lineitem
from bench.traffic import partitions

BIG = 2 ** 40 + 12345


# a dashboard's refreshes: 15 consecutive of 100 partitions
DASHBOARD = {"kind": "partitions", "partitions": 100, "span": 15}


def mix(name):
    return harness.load_json(harness.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, BIG])
def test_partition_starts_repeat(seed):
    m = DASHBOARD
    a = list(itertools.islice(partitions.starts(m, seed), 500))
    b = list(itertools.islice(partitions.starts(m, seed), 500))
    assert a == b
    assert min(a) >= 0 and max(a) <= m["partitions"] - m["span"]
    assert len(set(a)) > 50
    other = list(itertools.islice(partitions.starts(m, seed + 1), 500))
    assert a != other


def test_scan_reads_the_whole_table():
    m = mix("scan")
    assert set(itertools.islice(partitions.starts(m, BIG), 100)) == {0}
    assert partitions.lowered_rows(m, 600_000_000) == 600_000_000
    assert partitions.lowered_rows(DASHBOARD, 600_000_000) == 6_000_000
    with pytest.raises(ValueError):
        partitions.lowered_rows(DASHBOARD, 1001)


def config(name):
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["tpch-q6-sf100", "tpch-q1-sf100"])
def test_data_repeats_for_a_seed(name):
    cfg = config(name)
    make = harness.module("data", cfg["data"]["kind"]).make
    a, b, c = (make(cfg, 4096, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert list(a) == cfg["data"]["columns"]
    for k in a:
        assert a[k].dtype == torch.float32 and a[k].shape == (4096,)
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])


def test_both_queries_see_one_table():
    q6, q1 = (lineitem.make(config(n), 4096, 11, "cpu")
              for n in ("tpch-q6-sf100", "tpch-q1-sf100"))
    for k in q6:
        assert torch.equal(q6[k], q1[k])


def test_lineitem_follows_dbgen():
    cfg = dict(config("tpch-q1-sf100"))
    cfg["data"] = {"columns": ["shipdate", "returnflag", "linestatus",
                               "quantity", "extendedprice", "discount",
                               "tax"]}
    c = {k: v.numpy().astype(np.float64) for k, v in
         lineitem.make(cfg, 200_000, 3, "cpu").items()}
    ship = c["shipdate"]
    assert ship.min() >= 1 and ship.max() <= lineitem.ENDDATE - 151 + 121
    assert set(np.unique(c["quantity"])) == set(range(1, 51))
    # each decimal is the float32 nearest to it, as SQL's constants are
    assert np.array_equal(np.unique(c["discount"]),
                          np.float32(np.arange(11) / 100))
    assert np.array_equal(np.unique(c["tax"]), np.float32(np.arange(9) / 100))
    assert np.array_equal(c["extendedprice"],
                          np.float32(np.round(c["extendedprice"], 2)))
    # price = quantity x a retail price of 900.00 to 2,098.99
    unit = c["extendedprice"] / c["quantity"]
    assert unit.min() >= 900.0 - 1e-2 and unit.max() <= 2098.99 + 1e-2
    # shipped after CURRENTDATE: open; flag N where the receipt is later
    assert ((ship > lineitem.CURRENTDATE) == (c["linestatus"] == 1)).all()
    assert (c["returnflag"][ship > lineitem.CURRENTDATE] == 1).all()
    assert (c["returnflag"][ship <= lineitem.CURRENTDATE - 30] != 1).all()
    share_r = (c["returnflag"] == 2).sum() / (c["returnflag"] != 1).sum()
    assert abs(share_r - 0.5) < 0.01
