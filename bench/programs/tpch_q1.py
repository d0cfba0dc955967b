"""TPC-H Query 1, "Pricing Summary Report" (TPC-H v3.0.1, clause
2.4.1), at its validation parameter (DELTA 90 days):

    SELECT l_returnflag, l_linestatus, sum(l_quantity),
           sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount),
           count(*)
    FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval '90' day
    GROUP BY l_returnflag, l_linestatus

as a Map (each row's six aggregated values: quantity, price, discounted
price, charge, discount, 1) feeding a keyed fold over the groups.  The
key is returnflag * 2 + linestatus (``data/lineitem.py``'s codes, six
keys, four of them filled); a row the date excludes takes key -1, which
the fold drops.  The averages are the user's: a sum over its count.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.core import ir
from repro_torch.core.pipeline import Pipeline

COLUMNS = ("shipdate", "returnflag", "linestatus", "quantity",
           "extendedprice", "discount", "tax")
SHIP_LE = 2436.0                      # 1998-12-01 - 90 days
KEYS = 6                              # 3 return flags x 2 line statuses
VALUES = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
          "sum_disc", "count_order")


def pipeline(rows: int) -> Pipeline:
    ship, flag, status, qty, price, disc, tax = (
        ir.Tensor(c, (rows,)) for c in COLUMNS)
    nv = len(VALUES)

    def values_fn(s, q, pr, dc, tx):
        dp = pr * (1.0 - dc)
        return torch.stack([q, pr, dp, dp * (1.0 + tx), dc,
                            torch.ones_like(q)], -1)

    values = ir.Map(
        domain=(rows,), elem_shape=(nv,),
        reads=tuple(ir.elem(t) for t in (qty, price, disc, tax)),
        fn=values_fn,
        cuda=("const float pr = in1[0];\n"
              "const float dp = __fmul_rn(pr, __fsub_rn(1.0f, in2[0]));\n"
              "out[0] = in0[0];\n"
              "out[1] = pr;\n"
              "out[2] = dp;\n"
              "out[3] = __fmul_rn(dp, __fadd_rn(1.0f, in3[0]));\n"
              "out[4] = in2[0];\n"
              "out[5] = 1.0f;"),
        name="q1_values")

    def group_fn(s, sh, fl, st, v):
        key = torch.where(sh <= SHIP_LE, fl * 2.0 + st, -1.0)
        return key.to(torch.int32), v

    groups = ir.GroupByFold(
        domain=(rows,), num_keys=KEYS, elem_shape=(nv,),
        init=lambda: torch.zeros((KEYS, nv)),
        reads=(ir.elem(ship), ir.elem(flag), ir.elem(status),
               ir.Access(ir.Tensor("q1_values", (rows, nv)),
                         lambda i: (i, 0), (1, nv))),
        fn=group_fn, combine=operator.add,
        cuda=(f"key = in0[0] <= {SHIP_LE}f "
              f"? (int)(in1[0] * 2.0f + in2[0]) : -1;\n"
              f"for (int c = 0; c < {nv}; ++c) out[c] = in3[c];"),
        name="q1_groups")
    return Pipeline(name="tpch_q1", stages=(values, groups))
