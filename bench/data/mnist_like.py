"""MNIST-like points, drawn on the device from the seed: the stand-in for
MNIST8m (LIBSVM's ``mnist8m``: 8,100,000 28 x 28 digit images, pixels
scaled to [0, 1]), which the benchmark does not ship.

* ``COMPONENTS`` prototypes, each a 28 x 28 image of soft strokes: a 7 x 7
  uniform field upsampled bilinearly, the part above its 81st percentile
  kept and scaled to [0, 1] (about 19% of the pixels lit, as in MNIST);
* each point takes a prototype by uneven weights (weight of component i
  proportional to (i + 1) ** -ZIPF: the largest ~10x the smallest, so
  clusters differ in size), a shift of up to ``SHIFT`` pixels each way,
  a stroke intensity uniform in [0.7, 1] and Gaussian noise of sigma
  ``NOISE``; pixels under ``FLOOR`` are 0 and the rest clipped to 1.

Every value lies in [0, 1].  The same seed gives the same points.
"""
from __future__ import annotations

import torch

from .seeds import generator

SIDE = 28
COMPONENTS = 100
ZIPF = 0.5
SHIFT = 2
NOISE = 0.1
FLOOR = 0.1
LIT = 0.19          # share of a prototype's pixels lit
CHUNK = 1 << 20     # rows per step


def prototypes(g, device) -> torch.Tensor:
    """(COMPONENTS, (2 SHIFT + 1)^2, SIDE * SIDE): every prototype at
    every shift."""
    field = torch.rand(COMPONENTS, 1, 7, 7, generator=g, device=device)
    img = torch.nn.functional.interpolate(field, size=(SIDE, SIDE),
                                          mode="bilinear",
                                          align_corners=False)[:, 0]
    flat = img.reshape(COMPONENTS, -1)
    thr = flat.quantile(1.0 - LIT, dim=1, keepdim=True)
    top = flat.max(1, keepdim=True).values
    img = ((flat - thr) / (top - thr)).clamp(0.0, 1.0).reshape(
        COMPONENTS, SIDE, SIDE)
    shifts = [torch.roll(img, (dy, dx), dims=(1, 2))
              for dy in range(-SHIFT, SHIFT + 1)
              for dx in range(-SHIFT, SHIFT + 1)]
    return torch.stack(shifts, 1).reshape(COMPONENTS, len(shifts), -1)


def make(cfg: dict, rows: int, seed: int, device) -> dict:
    d = int(cfg["args"]["d"])
    if d != SIDE * SIDE:
        raise ValueError(f"MNIST-like points have {SIDE * SIDE} pixels, "
                         f"not {d}")
    g = generator(seed, device)
    protos = prototypes(g, device)
    weights = torch.arange(1, COMPONENTS + 1, dtype=torch.float64,
                           device=device) ** -ZIPF
    points = torch.empty(rows, d, dtype=torch.float32, device=device)
    n_shift = protos.shape[1]
    for i in range(0, rows, CHUNK):
        n = min(CHUNK, rows - i)
        comp = torch.multinomial(weights, n, replacement=True, generator=g)
        shift = torch.randint(0, n_shift, (n,), generator=g, device=device)
        scale = 0.7 + 0.3 * torch.rand(n, 1, generator=g, device=device)
        x = protos[comp, shift] * scale + NOISE * torch.randn(
            n, d, generator=g, device=device)
        points[i:i + n] = torch.where(x < FLOOR, 0.0, x.clamp(max=1.0))
    return {"points": points}
