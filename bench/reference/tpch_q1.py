"""TPC-H Query 1 as ``programs/tpch_q1.py`` states it: over the rows
whose shipdate is at most 1998-12-01 - 90 days, per (returnflag,
linestatus) group (key returnflag * 2 + linestatus, six keys), the sums
of quantity, extendedprice, extendedprice * (1 - discount), that times
(1 + tax), discount, and the count.

``answer`` takes the products of the float32 columns and the sums in
float64.  ``control`` holds the columns in bfloat16 and computes the
key and the products there, summing in float32 by reductions (float32
atomics would stop counting at 2^24).
"""
from __future__ import annotations

import numpy as np
import torch

SHIP_LE = 2436.0                      # 1998-12-01 - 90 days
KEYS, NV = 6, 6
BLOCK = 1 << 25     # rows per step
COLUMNS = ("shipdate", "returnflag", "linestatus", "quantity",
           "extendedprice", "discount", "tax")


def _table(columns: dict, dtype, acc) -> torch.Tensor:
    """Each group's sums and count, in blocks of rows: the columns and
    the row arithmetic in ``dtype``, each group's block summed by a
    reduction (no atomics) in ``acc``."""
    sh = columns["shipdate"]
    out = torch.zeros(KEYS, NV, dtype=acc, device=sh.device)
    le = torch.tensor(SHIP_LE, dtype=dtype, device=sh.device)
    for i in range(0, sh.shape[0], BLOCK):
        c = {k: columns[k][i:i + BLOCK].to(dtype) for k in COLUMNS}
        key = torch.where(c["shipdate"] <= le,
                          c["returnflag"] * 2 + c["linestatus"], -1)
        pr, dc = c["extendedprice"], c["discount"]
        dp = pr * (1 - dc)
        rows = torch.stack([c["quantity"], pr, dp, dp * (1 + c["tax"]), dc,
                            torch.ones_like(pr)], -1)
        zero = torch.zeros((), dtype=dtype, device=sh.device)
        for g in range(KEYS):
            out[g] += torch.where((key == g)[:, None], rows, zero) \
                .sum(0, dtype=acc)
    return out


def answer(columns: dict) -> np.ndarray:
    return _table(columns, torch.float64, torch.float64) \
        .reshape(-1).cpu().numpy()


def errors(got: np.ndarray, want: np.ndarray) -> dict:
    """``sums_err``: the largest gap of a group's sum over that sum;
    ``counts_err``: the largest gap of a group's count over the count
    (at least 1).  A group the reference leaves empty must come out 0."""
    got = np.asarray(got, np.float64).reshape(KEYS, NV)
    want = np.asarray(want, np.float64).reshape(KEYS, NV)
    gap = np.abs(got - want)
    sums = np.where(gap[:, :-1] > 0,
                    gap[:, :-1] / np.maximum(np.abs(want[:, :-1]), 1e-300),
                    0.0)
    counts = gap[:, -1] / np.maximum(want[:, -1], 1.0)
    return {"sums_err": float(sums.max()), "counts_err": float(counts.max())}


def ops(shapes: dict) -> int:
    """The values' subtract, add and two multiplies; the key's compare,
    multiply and add; six adds into the group's row."""
    return 13 * shapes["shipdate"][0]


def control(**columns):
    """The query in bfloat16 in the program's place."""
    return _table(columns, torch.bfloat16, torch.float32)
