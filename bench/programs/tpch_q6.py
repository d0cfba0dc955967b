"""TPC-H Query 6, "Forecasting Revenue Change" (TPC-H v3.0.1, clause
2.4.6), at its validation parameters (DATE 1994-01-01, DISCOUNT 0.06,
QUANTITY 24):

    SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem
    WHERE l_shipdate >= date '1994-01-01'
      AND l_shipdate < date '1994-01-01' + interval '1' year
      AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01
      AND l_quantity < 24

as a filter Map (each row's contribution, or 0) folded into one sum.
Dates are days since 1992-01-01 (``data/lineitem.py``); the constants
are float32, as the columns are.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.core import ir
from repro_torch.core.pipeline import Pipeline

COLUMNS = ("shipdate", "discount", "quantity", "extendedprice")
DATE_LO, DATE_HI = 731.0, 1096.0      # 1994-01-01, 1995-01-01
DISC_LO, DISC_HI = 0.05, 0.07
QTY_LT = 24.0


def pipeline(rows: int) -> Pipeline:
    ship, disc, qty, price = (ir.Tensor(c, (rows,)) for c in COLUMNS)

    def keep_fn(s, sh, dc, q, pr):
        keep = (sh >= DATE_LO) & (sh < DATE_HI) & (dc >= DISC_LO) & \
            (dc <= DISC_HI) & (q < QTY_LT)
        return torch.where(keep, pr * dc, 0.0)

    revenue = ir.Map(
        domain=(rows,),
        reads=tuple(ir.elem(t) for t in (ship, disc, qty, price)),
        fn=keep_fn,
        cuda=(f"const float sh = in0[0], dc = in1[0];\n"
              f"out[0] = (sh >= {DATE_LO}f && sh < {DATE_HI}f && "
              f"dc >= {DISC_LO}f && dc <= {DISC_HI}f && "
              f"in2[0] < {QTY_LT}f) ? __fmul_rn(in3[0], dc) : 0.0f;"),
        name="q6_revenue")
    total = ir.MultiFold(
        domain=(rows,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(ir.Tensor("q6_revenue", (rows,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: acc + v, combine=operator.add,
        cuda="out[0] = in0[0];", name="q6_sum")
    return Pipeline(name="tpch_q6", stages=(revenue, total))
