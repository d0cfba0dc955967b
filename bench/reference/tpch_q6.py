"""TPC-H Query 6 as ``programs/tpch_q6.py`` states it: the sum of
extendedprice * discount over the rows whose shipdate lies in 1994,
whose discount lies in [0.05, 0.07] and whose quantity is under 24,
with the program's float32 constants.

``answer`` is exact to float64: each product of two float32 values is
exact in float64, and a sum of at most 10^9 of them loses under 1e-15
of it.  ``control`` holds the columns in bfloat16 and computes the
predicate and the product there, summing in float32 (a bfloat16 sum of
10^8 terms would not be a sum).
"""
from __future__ import annotations

import numpy as np
import torch

DATE_LO, DATE_HI = 731.0, 1096.0      # 1994-01-01, 1995-01-01
DISC_LO, DISC_HI = 0.05, 0.07
QTY_LT = 24.0
BLOCK = 1 << 25     # rows per step


def _keep(sh, dc, q, dtype):
    c = {k: torch.tensor(v, dtype=dtype, device=sh.device) for k, v in
         (("lo", DATE_LO), ("hi", DATE_HI), ("dlo", DISC_LO),
          ("dhi", DISC_HI), ("q", QTY_LT))}
    return (sh >= c["lo"]) & (sh < c["hi"]) & (dc >= c["dlo"]) & \
        (dc <= c["dhi"]) & (q < c["q"])


def answer(columns: dict) -> np.ndarray:
    sh, dc, q, pr = (columns[k] for k in ("shipdate", "discount",
                                          "quantity", "extendedprice"))
    total = torch.zeros((), dtype=torch.float64, device=sh.device)
    for i in range(0, sh.shape[0], BLOCK):
        b = slice(i, i + BLOCK)
        keep = _keep(sh[b], dc[b], q[b], torch.float32)
        total += torch.where(keep, pr[b].double() * dc[b].double(), 0.0).sum()
    return np.array([total.item()])


def errors(got: np.ndarray, want: np.ndarray) -> dict:
    """``rel_err``: the answer's gap over the reference's value."""
    gap = np.abs(np.asarray(got, np.float64) - want)
    return {"rel_err": float(np.max(gap / np.maximum(np.abs(want),
                                                     1e-300)))}


def ops(shapes: dict) -> int:
    """5 compares, 4 ands, a multiply and the fold's add a row."""
    return 11 * shapes["shipdate"][0]


def control(shipdate, discount, quantity, extendedprice):
    """The query in bfloat16 in the program's place."""
    bf = torch.bfloat16
    total = torch.zeros((), dtype=torch.float32, device=shipdate.device)
    for i in range(0, shipdate.shape[0], BLOCK):
        b = slice(i, i + BLOCK)
        sh, dc, q, pr = (c[b].to(bf) for c in (shipdate, discount,
                                                quantity, extendedprice))
        prod = torch.where(_keep(sh, dc, q, bf), pr * dc,
                           torch.zeros((), dtype=bf, device=sh.device))
        total += prod.sum(dtype=torch.float32)
    return total
