"""One Lloyd step as ``programs/kmeans_lloyd.py`` states it, judged by the
choices float32 arithmetic admits.

A float32 squared distance over D terms, summed in any order, in the
difference form or as ||x||^2 - 2 x.c + ||c||^2, is within
tau (||x||^2 + ||c||^2) of the true one.  The worst case is tau = 2 D u
(u = 2^-24; 9.3e-5 at D = 784), which at D = 784 admits the TF32
control too: its errors (a 10-bit mantissa, ~5e-4 of a distance's
scale at most) stay inside that bound.  So ``tau`` is the probabilistic
bound of Higham and Mary ("A new approach to probabilistic rounding
error analysis", SIAM J. Sci. Comput. 41(5), 2019): rounding errors
independent and of mean zero, a sum of D terms is within
LAMBDA sqrt(D) u of its terms' magnitude except with a probability
below 2 D exp(-LAMBDA^2 / 2) (4e-5 of a pair within the bound at
LAMBDA = 6, and float32's errors sit ~50 standard deviations inside it;
1.0e-5 at D = 784).  The program may put a point in any cluster c whose
true distance exceeds the nearest one's, c*, by at most
tau (||x||^2 + ||c||^2) + tau (||x||^2 + ||c*||^2): the point's
admissible clusters.  ``answer`` computes the distances in float64, in
blocks of rows on the points' device, and gives each cluster's count and
sums an interval: from its sure points (those admitting it alone) to
those plus every ambiguous point admitting it (points are non-negative,
so the sums' bounds are the same sets).  ``errors`` reads how far the
program's count and sums lie outside, as a share of the cluster's
largest sum (its count).

``control`` is the same step with the distances in TF32 (inputs rounded
to TF32's 10-bit mantissa, the products summed in float32: the tensor
cores' float32 matmul with ``allow_tf32``), the next precision below
float32 on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 1 << 16     # rows per step


LAMBDA = 6.0


def tau(d: int) -> float:
    """The bound of a float32 distance's error over its terms' scale."""
    return LAMBDA * math.sqrt(d) * 2.0 ** -24


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits; halfway away from 0)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def answer(columns: dict) -> dict:
    """The interval of every cluster's count and sums, and the share of
    ambiguous points (float64 numpy)."""
    x_all, c = columns["points"], columns["centroids"]
    n, d = x_all.shape
    k = c.shape[0]
    cd = c.double()
    cc = (cd * cd).sum(1)
    t = tau(d)
    lo = torch.zeros(k, d + 1, dtype=torch.float64, device=c.device)
    extra = torch.zeros_like(lo)
    ambiguous = 0
    for i in range(0, n, BLOCK):
        x = x_all[i:i + BLOCK].double()
        xx = (x * x).sum(1)
        dist = xx[:, None] + cc[None, :] - 2.0 * (x @ cd.T)
        near = dist.argmin(1)
        slack = t * (2.0 * xx[:, None] + cc[None, :] + cc[near][:, None])
        adm = dist - dist.gather(1, near[:, None]) <= slack
        sure = adm.sum(1) == 1
        xe = torch.cat([x, torch.ones_like(xx)[:, None]], 1)
        lo.index_add_(0, near[sure], xe[sure])
        amb = ~sure
        if bool(amb.any()):
            extra += adm[amb].double().T @ xe[amb]
            ambiguous += int(amb.sum())
    return {"lo": lo.cpu().numpy(), "hi": (lo + extra).cpu().numpy(),
            "ambiguous": ambiguous / n}


def errors(got: dict, want: dict) -> dict:
    """``counts_err``: the largest distance of a cluster's count outside
    its interval over the count's upper bound (at least 1); ``sums_err``:
    the largest distance of a sum outside its interval over the
    cluster's largest upper bound of a sum (a cluster the interval
    leaves empty must come out 0)."""
    lo, hi = want["lo"], want["hi"]
    g = np.concatenate([np.asarray(got["km_sums"], np.float64),
                        np.asarray(got["km_counts"], np.float64)[:, None]],
                       1)
    out = np.maximum(lo - g, 0.0) + np.maximum(g - hi, 0.0)
    scale = np.maximum(hi[:, :-1].max(1), 1e-30)
    sums = np.where(out[:, :-1] > 0, out[:, :-1] / scale[:, None], 0.0)
    counts = out[:, -1] / np.maximum(hi[:, -1], 1.0)
    return {"sums_err": float(sums.max()), "counts_err": float(counts.max())}


def ops(shapes: dict) -> int:
    """The least work of any float32 implementation: a multiply-add per
    term of every point-centroid distance (2 n k d), a compare per
    distance (n k), and the folds' adds (n (d + 1))."""
    n, d = shapes["points"]
    k = shapes["centroids"][0]
    return 2 * n * k * d + n * k + n * (d + 1)


def kernel_work(n: int, k: int, d: int) -> dict:
    """Each kernel of the port's path: its least operations and bytes
    (each input read once, each output written once).  The assignment
    kernel reads the points and the centroids, does the distances, the
    compares and the counts' adds, and writes the keys; the fold kernel
    reads the points and the keys, adds them up and writes the k x d
    sums (how many partial tables it writes on the way is the program's
    choice, not the step's work)."""
    return {
        "nearest_assign_kernel": (2 * n * k * d + n * k + n,
                                  4 * (n * d + k * d + n)),
        "nearest_fold_kernel": (n * d, 4 * (n * d + n + k * d)),
    }


def control(points, centroids):
    """The step with its distances in TF32, in the program's place."""
    n, d = points.shape
    k = centroids.shape[0]
    c = _tf32(centroids)
    cc = (centroids * centroids).sum(1)
    keys = torch.empty(n, dtype=torch.int64, device=points.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for i in range(0, n, BLOCK):
            x = _tf32(points[i:i + BLOCK])
            keys[i:i + BLOCK] = (cc[None, :] - 2.0 * (x @ c.T)).argmin(1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sums = torch.zeros(k, d, dtype=torch.float64, device=points.device)
    for i in range(0, n, BLOCK):
        sums.index_add_(0, keys[i:i + BLOCK], points[i:i + BLOCK].double())
    counts = torch.bincount(keys, minlength=k).float()
    return {"km_sums": sums.float(), "km_counts": counts}
