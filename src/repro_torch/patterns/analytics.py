"""The paper's benchmark programs as PPL, with torch and CUDA bodies.

``SUITE`` holds the single patterns of the paper's Table 5: outerprod,
sumrows, gemm, tpchq6, gda and kmeans (``codegen_cuda.lower`` takes the
tiled outerprod, gemm and gda; the others have no template, as in the
reference).  ``PIPELINES`` holds the composed programs the fused
megakernel runs: tpchq6, gda, kmeans, gda_moments and normalize.  The
numpy ``make_inputs`` use the same seeds as the JAX reference, so both
packages see identical data.  Every pattern carries a torch body
(batched over leading dimensions, see ``core.ir``); every one a CUDA
template takes also carries the same body as CUDA C++ statements.  The
``reference`` functions are vectorised numpy, accumulating in float64,
so they run at full size.

Builders return ``(pattern, tile_sizes, make_inputs, reference)`` for
``SUITE`` and ``(Pipeline, make_inputs, reference)`` for ``PIPELINES``;
multi-output references return a name -> array dict.
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.pipeline import Pipeline


def _rng(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _keys(labels: torch.Tensor) -> torch.Tensor:
    """f32 class labels to int32 keys, truncating like ``astype``."""
    return labels.to(torch.int32)


# ------------------------------------------------------------- outerprod
def outerprod(m=256, n=256, bm=64, bn=64):
    """Vector outer product: a 2-D Map, one float32 multiply per element."""
    x = ir.Tensor("x", (m,))
    y = ir.Tensor("y", (n,))
    p = ir.Map(
        domain=(m, n),
        reads=(ir.Access(x, lambda i, j: (i,), (1,)),
               ir.Access(y, lambda i, j: (j,), (1,))),
        fn=lambda s, xe, ye: xe * ye,
        cuda="out[0] = in0[0] * in1[0];", name="outer")
    sizes = {"outer": (bm, bn)}

    def make_inputs():
        return {"x": _rng(0, m), "y": _rng(1, n)}

    def reference(inp):
        return np.outer(inp["x"], inp["y"])

    return p, sizes, make_inputs, reference


# --------------------------------------------------------------- sumrows
def sumrows(m=256, n=256, b0=64, b1=64):
    """Row sums as a MultiFold (m, n) -> (m,)."""
    x = ir.Tensor("x", (m, n))
    p = ir.MultiFold(
        domain=(m, n), range_shape=(m,), init=lambda: torch.zeros((m,)),
        reads=(ir.elem(x),),
        out_index_map=lambda i, j: (i,), update_shape=(1,),
        fn=lambda s, acc, e: acc + e, combine=operator.add, name="sumrows")
    sizes = {"sumrows": (b0, b1)}

    def make_inputs():
        return {"x": _rng(2, m, n)}

    def reference(inp):
        return inp["x"].sum(1, dtype=np.float64).astype(np.float32)

    return p, sizes, make_inputs, reference


# ------------------------------------------------------------------ gemm
def gemm(m=128, n=128, k=128, bm=64, bn=64, bk=64):
    x = ir.Tensor("x", (m, k))
    y = ir.Tensor("y", (k, n))
    kfold = ir.MultiFold(
        domain=(k,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.Access(x, lambda i, j, kk: (i, kk), (1, 1)),
               ir.Access(y, lambda i, j, kk: (kk, j), (1, 1))),
        out_index_map=lambda i, j, kk: (), update_shape=(),
        fn=lambda s, acc, xe, ye: acc + xe * ye,
        combine=operator.add, name="gemm_k")
    p = ir.Map(domain=(m, n), inner=kfold, name="gemm")
    sizes = {"gemm": (bm, bn), "gemm_k": (bk,)}

    def make_inputs():
        return {"x": _rng(3, m, k), "y": _rng(4, k, n)}

    def reference(inp):
        return (inp["x"].astype(np.float64)
                @ inp["y"].astype(np.float64)).astype(np.float32)

    return p, sizes, make_inputs, reference


# ---------------------------------------------------------------- tpchq6
def tpchq6(n=4096, b=512):
    """SELECT sum(price * discount) WHERE lo <= qty < hi as one fold (the
    filter fuses into the fold)."""
    qty = ir.Tensor("qty", (n,))
    price = ir.Tensor("price", (n,))
    disc = ir.Tensor("disc", (n,))
    lo, hi = 0.05, 0.95

    def fn(s, acc, q, pr, dc):
        return acc + torch.where((q >= lo) & (q < hi), pr * dc, 0.0)

    p = ir.MultiFold(
        domain=(n,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(qty), ir.elem(price), ir.elem(disc)),
        out_index_map=lambda i: (), update_shape=(),
        fn=fn, combine=operator.add, name="q6")
    sizes = {"q6": (b,)}
    _, make_inputs, reference = tpchq6_pipeline(n)
    return p, sizes, make_inputs, reference


# ------------------------------------------------------------------- gda
def gda(n=512, d=8, k=4, b0=64):
    """Per-class scatter moments sum_k [x_i ; x_i x_i^T] as one keyed
    fold: map + groupBy + reduce (the paper's GDA core)."""
    pts = ir.Tensor("pts", (n, d))
    labels = ir.Tensor("labels", (n,))
    ew = d + d * d

    def fn(s, lab, row):
        outer = row[..., :, None] * row[..., None, :]
        return _keys(lab), torch.cat([row, outer.flatten(-2)], -1)

    p = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(ew,),
        init=lambda: torch.zeros((k, ew)),
        reads=(ir.elem(labels),
               ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=fn, combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {d}; ++a) {{\n"
              f"  out[a] = in1[a];\n"
              f"  for (int c = 0; c < {d}; ++c)\n"
              f"    out[{d} + a * {d} + c] = in1[a] * in1[c];\n"
              f"}}"),
        name="gda")
    sizes = {"gda": (b0,)}
    _, make_inputs, reference = gda_pipeline(n, d, k)
    return p, sizes, make_inputs, reference


# ---------------------------------------------------------------- kmeans
def sq_dist(c_row, p_row):
    """Squared distance summed over the last dim in index order, one
    multiply and one add per term (see ``kmeans_pipeline``)."""
    s = torch.zeros(torch.broadcast_shapes(c_row.shape[:-1],
                                           p_row.shape[:-1]),
                    device=p_row.device)
    for a in range(p_row.shape[-1]):
        t = c_row[..., a] - p_row[..., a]
        s = s + t * t
    return s


def _nearest(pts_, cents_):
    """Each row's nearest centroid (first minimum), the distance summed
    in index order as the pattern bodies sum it."""
    n, k = pts_.shape[0], cents_.shape[0]
    idx = np.empty(n, np.int64)
    step = 1 << 18       # rows per chunk: bounds the (rows, k) temp
    for i0 in range(0, n, step):
        p = pts_[i0:i0 + step]
        d2 = np.zeros((p.shape[0], k), np.float32)
        for a in range(pts_.shape[1]):
            t = cents_[None, :, a] - p[:, None, a]
            d2 = d2 + t * t
        idx[i0:i0 + step] = d2.argmin(1)
    return idx


def kmeans(n=256, k=8, d=16, b0=32, b1=4):
    """One k-means step as a keyed fold whose key is an assignment fold
    over the centroids (paper Fig. 4).  No CUDA template takes it: the
    scatter reads the assignment fold, not a tensor tile."""
    pts = ir.Tensor("points", (n, d))
    cents = ir.Tensor("centroids", (k, d))

    def assign_fn(s, acc, c_row, p_row):
        d2 = sq_dist(c_row, p_row)
        j = torch.as_tensor(s[-1], dtype=d2.dtype, device=d2.device)
        new = torch.stack([d2, j.expand_as(d2)], -1)
        return torch.where((d2 < acc[..., 0])[..., None], new, acc)

    assign = ir.MultiFold(
        domain=(k,), range_shape=(2,),
        init=lambda: torch.tensor([float("inf"), -1.0]),
        reads=(ir.Access(cents, lambda i, j: (j, 0), (1, d)),
               ir.Access(pts, lambda i, j: (i, 0), (1, d))),
        out_index_map=lambda i, j: (0,), update_shape=(2,),
        fn=assign_fn,
        combine=lambda a, b: torch.where(a[..., :1] <= b[..., :1], a, b),
        name="assign")

    def scatter_fn(s, pair, p_row):
        ones = torch.ones(p_row.shape[:-1] + (1,), device=p_row.device)
        return pair[..., 1].to(torch.int32), torch.cat([p_row, ones], -1)

    p = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(d + 1,),
        init=lambda: torch.zeros((k, d + 1)),
        reads=(ir.Access(assign, lambda i: (0,), (2,)),
               ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=scatter_fn, combine=operator.add, name="scatter")
    sizes = {"scatter": (b0,), "assign": (b1,)}

    def make_inputs():
        return {"points": _rng(7, n, d), "centroids": _rng(8, k, d)}

    def reference(inp):
        idx = _nearest(inp["points"], inp["centroids"])
        out = np.zeros((k, d + 1), np.float64)
        x = inp["points"].astype(np.float64)
        for c in range(k):
            out[c, :d] = x[idx == c].sum(0)
            out[c, d] = (idx == c).sum()
        return out.astype(np.float32)

    return p, sizes, make_inputs, reference


SUITE = {
    "outerprod": outerprod,
    "sumrows": sumrows,
    "gemm": gemm,
    "tpchq6": tpchq6,
    "gda": gda,
    "kmeans": kmeans,
}


# ==========================================================================
# Pipelines: DAGs of whole patterns wired through named intermediates --
# the programs pipeline fusion lowers as single megakernels.
# ==========================================================================


def tpchq6_pipeline(n=4096):
    """tpchq6 as filter -> fold: SELECT sum(price * discount) WHERE
    lo <= qty < hi.  A mask Map produces the per-record contribution
    (the (n,) intermediate), summed by a separate fold."""
    qty = ir.Tensor("qty", (n,))
    price = ir.Tensor("price", (n,))
    disc = ir.Tensor("disc", (n,))
    lo, hi = 0.05, 0.95

    mask = ir.Map(
        domain=(n,),
        reads=(ir.elem(qty), ir.elem(price), ir.elem(disc)),
        fn=lambda s, q, pr, dc: torch.where((q >= lo) & (q < hi),
                                            pr * dc, 0.0),
        cuda=(f"const float q = in0[0];\n"
              f"out[0] = (q >= {lo}f && q < {hi}f) ? in1[0] * in2[0] : 0.0f;"),
        name="q6_mask")
    total = ir.MultiFold(
        domain=(n,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(ir.Tensor("q6_mask", (n,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: acc + v, combine=operator.add,
        cuda="out[0] = in0[0];", name="q6_sum")

    def make_inputs():
        r = np.random.RandomState(5)
        return {"qty": r.rand(n).astype(np.float32),
                "price": r.rand(n).astype(np.float32),
                "disc": r.rand(n).astype(np.float32)}

    def reference(inp):
        pred = (inp["qty"] >= np.float32(lo)) & (inp["qty"] < np.float32(hi))
        contrib = np.where(pred, inp["price"] * inp["disc"], np.float32(0))
        return np.float32(contrib.sum(dtype=np.float64))

    return Pipeline(name="tpchq6", stages=(mask, total)), \
        make_inputs, reference


def _class_rows(labels: np.ndarray, k: int):
    """Per class c in [0, k): the boolean mask of its rows (labels
    truncated to int32, as the pattern bodies key them)."""
    lab = labels.astype(np.int32)
    return [lab == c for c in range(k)]


def gda_pipeline(n=512, d=8, k=4):
    """gda as map -> keyed fold: a feature Map producing [x ; x x^T] per
    point (the (n, d + d*d) intermediate), scattered per class."""
    pts = ir.Tensor("pts", (n, d))
    labels = ir.Tensor("labels", (n,))
    ew = d + d * d

    def feat_fn(s, row):
        outer = row[..., :, None] * row[..., None, :]
        return torch.cat([row, outer.flatten(-2)], -1)

    feat = ir.Map(
        domain=(n,), elem_shape=(ew,),
        reads=(ir.Access(pts, lambda i: (i, 0), (1, d)),),
        fn=feat_fn,
        cuda=(f"for (int a = 0; a < {d}; ++a) {{\n"
              f"  out[a] = in0[a];\n"
              f"  for (int c = 0; c < {d}; ++c)\n"
              f"    out[{d} + a * {d} + c] = in0[a] * in0[c];\n"
              f"}}"),
        name="gda_feat")
    scatter = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(ew,),
        init=lambda: torch.zeros((k, ew)),
        reads=(ir.elem(labels),
               ir.Access(ir.Tensor("gda_feat", (n, ew)),
                         lambda i: (i, 0), (1, ew))),
        fn=lambda s, lab, f: (_keys(lab), f), combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int c = 0; c < {ew}; ++c) out[c] = in1[c];"),
        name="gda_scatter")

    def make_inputs():
        r = np.random.RandomState(6)
        return {"pts": r.randn(n, d).astype(np.float32),
                "labels": r.randint(0, k, n).astype(np.float32)}

    def reference(inp):
        out = np.zeros((k, ew), np.float64)
        x = inp["pts"].astype(np.float64)
        for c, rows in enumerate(_class_rows(inp["labels"], k)):
            xc = x[rows]
            out[c, :d] = xc.sum(0)
            out[c, d:] = (xc.T @ xc).reshape(-1)
        return out.astype(np.float32)

    return Pipeline(name="gda", stages=(feat, scatter)), \
        make_inputs, reference


def kmeans_pipeline(n=256, k=8, d=16):
    """kmeans step in DAG form: the assign Map (each point's nearest
    centroid, the (n,) fan-out intermediate) feeds BOTH the per-cluster
    scatter-sum and the per-cluster count.  Fused, the assignment is
    computed once per tile into one on-chip stage buffer read by both
    terminals; the centroids read is loop-invariant (the Pipe-0
    preload).  Ties go to the first centroid, as ``argmin`` gives.

    The squared distance is summed over ``d`` in order, one float32
    multiply and one add per term (no fused multiply-add), in the torch
    body, the CUDA body and the reference alike: the three then agree
    bitwise, so a point nearly equidistant from two centroids cannot
    land in different clusters through rounding alone."""
    pts = ir.Tensor("points", (n, d))
    cents = ir.Tensor("centroids", (k, d))

    def assign_fn(s, c_all, p_row):
        d2 = sq_dist(c_all, p_row[..., None, :])
        return torch.argmin(d2, -1).to(torch.float32)

    assign = ir.Map(
        domain=(n,),
        reads=(ir.whole(cents),
               ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=assign_fn,
        cuda=(f"float best = INFINITY;\n"
              f"int arg = 0;\n"
              f"for (int c = 0; c < {k}; ++c) {{\n"
              f"  float s = 0.0f;\n"
              f"  for (int a = 0; a < {d}; ++a) {{\n"
              f"    const float t = in0[c * {d} + a] - in1[a];\n"
              f"    s = __fadd_rn(s, __fmul_rn(t, t));\n"
              f"  }}\n"
              f"  if (s < best) {{ best = s; arg = c; }}  // first minimum\n"
              f"}}\n"
              f"out[0] = (float)arg;"),
        name="km_assign")

    sums = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(d,),
        init=lambda: torch.zeros((k, d)),
        reads=(ir.elem(ir.Tensor("km_assign", (n,))),
               ir.Access(pts, lambda i: (i, 0), (1, d))),
        fn=lambda s, a, p_row: (_keys(a), p_row), combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {d}; ++a) out[a] = in1[a];"),
        name="km_sums")

    counts = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(),
        init=lambda: torch.zeros((k,)),
        reads=(ir.elem(ir.Tensor("km_assign", (n,))),),
        fn=lambda s, a: (_keys(a), torch.ones_like(a)),
        combine=operator.add,
        cuda="key = (int)in0[0];\nout[0] = 1.0f;",
        name="km_counts")

    def make_inputs():
        return {"points": _rng(7, n, d), "centroids": _rng(8, k, d)}

    def reference(inp):
        pts_ = inp["points"]
        idx = _nearest(pts_, inp["centroids"])
        sums_ = np.zeros((k, d), np.float64)
        counts_ = np.bincount(idx, minlength=k).astype(np.float32)
        x = pts_.astype(np.float64)
        for c in range(k):
            sums_[c] = x[idx == c].sum(0)
        return {"km_sums": sums_.astype(np.float32), "km_counts": counts_}

    return Pipeline(name="kmeans", stages=(assign, sums, counts)), \
        make_inputs, reference


def gda_moments_pipeline(n=512, d=8, k=4):
    """gda first/second moments as a DAG over one shared feature map:
    a weighted feature Map (the (n, d) fan-out intermediate) feeds BOTH
    the per-class mean and the per-class second-moment accumulator.  The
    labels tile is read by both terminals but copied once; the weight
    vector is a Pipe-0 preload."""
    pts = ir.Tensor("pts", (n, d))
    labels = ir.Tensor("labels", (n,))
    weight = ir.Tensor("weight", (d,))

    feat = ir.Map(
        domain=(n,), elem_shape=(d,),
        reads=(ir.Access(pts, lambda i: (i, 0), (1, d)),
               ir.whole(weight)),
        fn=lambda s, row, w: row * w,
        cuda=f"for (int a = 0; a < {d}; ++a) out[a] = in0[a] * in1[a];",
        name="gdam_feat")

    mean = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(d,),
        init=lambda: torch.zeros((k, d)),
        reads=(ir.elem(labels),
               ir.Access(ir.Tensor("gdam_feat", (n, d)),
                         lambda i: (i, 0), (1, d))),
        fn=lambda s, lab, f: (_keys(lab), f), combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {d}; ++a) out[a] = in1[a];"),
        name="gdam_mean")

    var = ir.GroupByFold(
        domain=(n,), num_keys=k, elem_shape=(d,),
        init=lambda: torch.zeros((k, d)),
        reads=(ir.elem(labels),
               ir.Access(ir.Tensor("gdam_feat", (n, d)),
                         lambda i: (i, 0), (1, d))),
        fn=lambda s, lab, f: (_keys(lab), f * f), combine=operator.add,
        cuda=(f"key = (int)in0[0];\n"
              f"for (int a = 0; a < {d}; ++a) out[a] = in1[a] * in1[a];"),
        name="gdam_var")

    def make_inputs():
        r = np.random.RandomState(9)
        return {"pts": r.randn(n, d).astype(np.float32),
                "labels": r.randint(0, k, n).astype(np.float32),
                "weight": (r.rand(d) + 0.5).astype(np.float32)}

    def reference(inp):
        f = inp["pts"] * inp["weight"][None, :]
        mean_ = np.zeros((k, d), np.float64)
        var_ = np.zeros((k, d), np.float64)
        for c, rows in enumerate(_class_rows(inp["labels"], k)):
            fc = f[rows]
            mean_[c] = fc.sum(0, dtype=np.float64)
            var_[c] = (fc * fc).sum(0, dtype=np.float64)
        return {"gdam_mean": mean_.astype(np.float32),
                "gdam_var": var_.astype(np.float32)}

    return Pipeline(name="gda_moments", stages=(feat, mean, var)), \
        make_inputs, reference


def normalize_pipeline(n=256, d=16):
    """L2 row normalization as map -> map: an inverse-norm Map (the (n,)
    intermediate) feeding a *Map terminal* that rescales each row; the
    terminal writes one (b, d) output block per grid step.  The x tile
    feeds both stages through a single copy."""
    x = ir.Tensor("x", (n, d))
    eps = 1e-6

    inv = ir.Map(
        domain=(n,),
        reads=(ir.Access(x, lambda i: (i, 0), (1, d)),),
        fn=lambda s, row: 1.0 / torch.sqrt((row * row).sum(-1) + eps),
        cuda=(f"float s = 0.0f;\n"
              f"for (int a = 0; a < {d}; ++a) s += in0[a] * in0[a];\n"
              f"out[0] = 1.0f / sqrtf(s + {eps}f);"),
        name="nrm_inv")

    scale = ir.Map(
        domain=(n,), elem_shape=(d,),
        reads=(ir.elem(ir.Tensor("nrm_inv", (n,))),
               ir.Access(x, lambda i: (i, 0), (1, d))),
        fn=lambda s, r, row: row * r.unsqueeze(-1),
        cuda=f"for (int a = 0; a < {d}; ++a) out[a] = in1[a] * in0[0];",
        name="nrm_out")

    def make_inputs():
        return {"x": _rng(10, n, d)}

    def reference(inp):
        xs = inp["x"].astype(np.float64)
        out = xs / np.sqrt((xs * xs).sum(1, keepdims=True) + eps)
        return out.astype(np.float32)

    return Pipeline(name="normalize", stages=(inv, scale)), \
        make_inputs, reference


PIPELINES = {
    "tpchq6": tpchq6_pipeline,
    "gda": gda_pipeline,
    "kmeans": kmeans_pipeline,
    "gda_moments": gda_moments_pipeline,
    "normalize": normalize_pipeline,
}
