"""One step of Lloyd's k-means (the paper's k-means benchmark; the
step faiss runs on MNIST8m in Johnson, Douze and Jegou, "Billion-scale
similarity search with GPUs", arXiv:1702.08734):

    assign[i]  = argmin_c ||points[i] - centroids[c]||^2  (first on ties)
    km_sums[c] = sum of the points assigned to c          (k x d)
    km_counts[c] = the number of points assigned to c     (k)

as an assignment Map feeding a keyed sum of rows and a keyed count, as
``repro_torch.patterns.analytics.kmeans_pipeline`` writes it.  The
assignment declares itself an argmin over the centroid table's rows
(``nearest``) and the sum a keyed sum of rows (``keyed_rows``), which
lets the compiler strip-mine the table into tiles of centroids and fold
the sums a column slice at a time.  The client (``traffic/lloyd.py``)
takes the new centroids as sums over counts.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.core import ir
from repro_torch.core.pipeline import Pipeline


def _keys(a):
    return a.to(torch.int64)


def pipeline(rows: int, k: int, d: int) -> Pipeline:
    pts = ir.Tensor("points", (rows, d))
    cents = ir.Tensor("centroids", (k, d))

    def assign_fn(s, c_all, p_row):
        d2 = ((c_all - p_row[..., None, :]) ** 2).sum(-1)
        return torch.argmin(d2, -1).to(torch.float32)

    assign = ir.Map(
        domain=(rows,),
        reads=(ir.whole(cents), ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=assign_fn,
        cuda=(f"float best = INFINITY;\n"
              f"int arg = 0;\n"
              f"for (int c = 0; c < {k}; ++c) {{\n"
              f"  float s = 0.0f;\n"
              f"  for (int a = 0; a < {d}; ++a) {{\n"
              f"    const float t = in0[c * {d} + a] - in1[a];\n"
              f"    s = fmaf(t, t, s);\n"
              f"  }}\n"
              f"  if (s < best) {{ best = s; arg = c; }}  // first minimum\n"
              f"}}\n"
              f"out[0] = (float)arg;"),
        name="km_assign", nearest=(0, 1))

    sums = ir.GroupByFold(
        domain=(rows,), num_keys=k, elem_shape=(d,),
        init=lambda: torch.zeros((k, d)),
        reads=(ir.elem(ir.Tensor("km_assign", (rows,))),
               ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=lambda s, a, p_row: (_keys(a), p_row), combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {d}; ++a) out[a] = in1[a];"),
        name="km_sums", keyed_rows=(0, 1))

    counts = ir.GroupByFold(
        domain=(rows,), num_keys=k, elem_shape=(),
        init=lambda: torch.zeros((k,)),
        reads=(ir.elem(ir.Tensor("km_assign", (rows,))),),
        fn=lambda s, a: (_keys(a), torch.ones_like(a)),
        combine=operator.add,
        cuda="key = (int)in0[0];\nout[0] = 1.0f;",
        name="km_counts")
    return Pipeline(name="kmeans_lloyd", stages=(assign, sums, counts))
