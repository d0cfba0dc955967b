"""TPC-H's lineitem table, drawn as the specification's dbgen draws it
(TPC-H v3.0.1, clause 4.2.3), on the device from the seed:

* O_ORDERDATE uniform in [STARTDATE, ENDDATE - 151 days];
  L_SHIPDATE = O_ORDERDATE + [1, 121] days; L_RECEIPTDATE =
  L_SHIPDATE + [1, 30] days;
* L_QUANTITY uniform in [1, 50]; L_DISCOUNT in [0.00, 0.10] and L_TAX
  in [0.00, 0.08], in steps of 0.01;
* L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE, with L_PARTKEY uniform
  in [1, SF * 200,000] and P_RETAILPRICE = (90000 + ((P_PARTKEY / 10)
  mod 20001) + 100 * (P_PARTKEY mod 1000)) / 100;
* L_RETURNFLAG "R" or "A" at random where L_RECEIPTDATE <= CURRENTDATE,
  else "N"; L_LINESTATUS "O" where L_SHIPDATE > CURRENTDATE, else "F".

Each row is drawn on its own (dbgen shares an order's date among its
one to seven lines).  Every column is float32: dates as days since
1992-01-01, the flags as codes (``FLAGS``, ``STATUS``), the decimals
rounded to the nearest float32.  The same seed gives the same table
whichever columns a configuration keeps (``data.columns``).
"""
from __future__ import annotations

import torch

from .seeds import generator

STARTDATE, CURRENTDATE, ENDDATE = 0, 1263, 2556   # 1992-01-01, 1995-06-17,
#                                                   1998-12-31
FLAGS = "ANR"       # L_RETURNFLAG codes 0, 1, 2 (Q1's order)
STATUS = "FO"       # L_LINESTATUS codes 0, 1
CHUNK = 1 << 25     # rows per step


def make(cfg: dict, rows: int, seed: int, device) -> dict:
    parts = 200_000 * int(cfg["scale_factor"])
    names = cfg["data"]["columns"]
    g = generator(seed, device)
    out = {n: torch.empty(rows, dtype=torch.float32, device=device)
           for n in names}

    def draw(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    # a decimal's float32 is the nearest to it: on the card a division by
    # a number is a multiply by its reciprocal, one unit off in the last
    # place for some, so the decimals are looked up and the prices divided
    # elementwise
    cents = torch.arange(11, dtype=torch.float64).div(100).float().to(device)
    hundred = torch.full((CHUNK,), 100.0, dtype=torch.float64, device=device)
    for i in range(0, rows, CHUNK):
        n = min(CHUNK, rows - i)
        ship = draw(STARTDATE, ENDDATE - 151, n) + draw(1, 121, n)
        receipt = ship + draw(1, 30, n)
        coin = draw(0, 1, n)
        qty = draw(1, 50, n)
        pk = draw(1, parts, n)
        disc = draw(0, 10, n)
        tax = draw(0, 8, n)
        cols = {
            "shipdate": lambda: ship,
            "quantity": lambda: qty,
            "extendedprice": lambda: (qty * (90000 + (pk // 10) % 20001
                                             + 100 * (pk % 1000))
                                      ).double().div(hundred[:n]),
            "discount": lambda: cents[disc],
            "tax": lambda: cents[tax],
            "returnflag": lambda: torch.where(receipt <= CURRENTDATE,
                                              2 * coin, 1),
            "linestatus": lambda: (ship > CURRENTDATE).long(),
        }
        for name in names:
            out[name][i:i + n] = cols[name]().float()
    return out
