"""Affine index-map utilities.

The paper's tiling rules are *pattern matching*, not polyhedral: the only
arithmetic fact they need is the (affine) stride of each access with
respect to each loop index.  Because ``Access.index_map`` callables are
declared affine, we recover ``f(i) = base + M @ i`` exactly by probing
with unit indices -- no symbolic algebra, and non-affine accesses simply
opt out (``affine=False``) instead of failing the whole program (the
paper's key advantage over polyhedral tiling).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple



@dataclass(frozen=True)
class AffineMap:
    """``f(idxs) = base + mat @ idxs`` with integer entries.

    ``mat[out_dim][in_dim]``; ``n_in`` inputs, ``len(base)`` outputs.
    """

    base: Tuple[int, ...]
    mat: Tuple[Tuple[int, ...], ...]
    arity: int = -1  # explicit n_in (needed when n_out == 0)

    @property
    def n_in(self) -> int:
        if self.arity >= 0:
            return self.arity
        return len(self.mat[0]) if self.mat else 0

    @property
    def n_out(self) -> int:
        return len(self.base)

    def __call__(self, *idxs):
        assert len(idxs) == self.n_in, (len(idxs), self.n_in)
        return tuple(
            b + sum(m * i for m, i in zip(row, idxs))
            for b, row in zip(self.base, self.mat)
        )

    @staticmethod
    def probe(fn: Callable, n_in: int) -> "AffineMap":
        """Recover an AffineMap from an affine callable by unit probing."""
        zero = (0,) * n_in
        base = tuple(int(v) for v in fn(*zero))
        cols = []
        for j in range(n_in):
            unit = tuple(1 if k == j else 0 for k in range(n_in))
            cols.append([int(v) - b for v, b in zip(fn(*unit), base)])
        mat = tuple(tuple(cols[j][d] for j in range(n_in))
                    for d in range(len(base)))
        return AffineMap(base, mat, arity=n_in)

    def depends_on(self, in_dim: int) -> bool:
        return any(row[in_dim] != 0 for row in self.mat)

    def dependent_dims(self) -> Tuple[int, ...]:
        return tuple(j for j in range(self.n_in) if self.depends_on(j))

    def col(self, in_dim: int) -> Tuple[int, ...]:
        return tuple(row[in_dim] for row in self.mat)

    def drop_inputs(self, keep: Sequence[int]) -> "AffineMap":
        """Restrict to a subset of inputs (others assumed zero)."""
        mat = tuple(tuple(row[j] for j in keep) for row in self.mat)
        return AffineMap(self.base, mat, arity=len(keep))

    def with_zero_base(self) -> "AffineMap":
        return AffineMap((0,) * self.n_out, self.mat, arity=self.n_in)

    def scaled_inputs(self, scales: Sequence[int]) -> "AffineMap":
        """f'(i) = f(scales * i) -- used for grid->element index maps."""
        mat = tuple(tuple(m * s for m, s in zip(row, scales))
                    for row in self.mat)
        return AffineMap(self.base, mat, arity=self.n_in)

    def permuted_inputs(self, perm: Sequence[int]) -> "AffineMap":
        """f'(i) = f(i[perm]) (new input j reads old input perm[j])."""
        mat = tuple(tuple(row[p] for p in perm) for row in self.mat)
        return AffineMap(self.base, mat, arity=len(perm))

    def extended(self, n_extra_front: int, n_extra_back: int) -> "AffineMap":
        """Add ignored inputs before/after the existing ones."""
        mat = tuple(
            (0,) * n_extra_front + tuple(row) + (0,) * n_extra_back
            for row in self.mat
        )
        return AffineMap(self.base, mat,
                         arity=n_extra_front + self.n_in + n_extra_back)


def touched_extent(col_strides: Sequence[Tuple[int, ...]],
                   tile_sizes: Sequence[int],
                   window: Sequence[int]) -> Tuple[int, ...]:
    """Extent of the region touched by a tile of iterations.

    For each output dim d: ``sum_j |stride_j[d]| * (b_j - 1) + window[d]``.
    This is the tile-copy shape rule (sliding windows give overlap and are
    marked with a reuse factor by the caller).
    """
    n_out = len(window)
    ext = list(window)
    for col, b in zip(col_strides, tile_sizes):
        for d in range(n_out):
            ext[d] += abs(col[d]) * (b - 1)
    return tuple(ext)
